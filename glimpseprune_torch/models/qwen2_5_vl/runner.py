"""The user-facing runner: pruned and unpruned greedy generation.

Counterpart of glimpseprune_tpu/models/qwen2_5_vl/runner.py
(``GlimpsePruneRunner.__init__`` / ``glimpse`` / ``generate`` :437-936 and
``_decode_loop`` / ``_run_decode`` / ``_trim_eos`` / ``_first_stop_match``
:1053-1190). The JAX package decodes in jitted ``lax.scan`` chunks
(``gp_model.decode_chunk``); here the decode is a plain Python loop over
steps and layers, with the early-exit check between chunks of steps so the
host syncs once per chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.models.qwen2_5_vl.gp_model import GlimpseOutputs, Qwen2_5_VL_GP
from glimpseprune_torch.models.qwen2_5_vl.inputs import PreparedInputs, _vis_dense_hint
from glimpseprune_torch.ops.kv_cache import alloc_cache, cache_set_prefix

DECODE_CHUNK = 32  # decode steps between host-side eos / stop-sequence checks


@dataclass
class GenerateResult:
    sequences: np.ndarray            # [B, max_new] generated ids (eos after the end)
    num_generated: np.ndarray        # [B]
    keep_img: Optional[np.ndarray]   # [B, N]
    mask_logits: Optional[np.ndarray]
    prune_ratio: Optional[np.ndarray]  # [B] fraction of image tokens dropped


class PrefillResult(NamedTuple):
    logits: torch.Tensor          # [B, 1, V] at the last position
    valid: torch.Tensor           # [B, R]
    position_ids: torch.Tensor    # [3, B, R]
    kv_k: torch.Tensor            # [L, B, R, Hkv, D]
    kv_v: torch.Tensor
    keep_img: Optional[torch.Tensor]     # [B, N], pruned prefill only
    mask_logits: Optional[torch.Tensor]  # [n_out, B, N], pruned prefill only


class GlimpsePruneRunner:
    """Owns the model (weights on their device) and runs generate()."""

    def __init__(self, cfg: ModelConfig, model: Qwen2_5_VL_GP):
        self.cfg = cfg.validate()
        gp = self.cfg.gp
        for knob in ("use_ref_masks", "use_zero_masks", "per_image_policy"):
            if getattr(gp, knob):
                raise ValueError(f"gp.{knob} is not ported to the torch runner yet")
        self.model = model.eval()
        self.device = model.text.embed_tokens.weight.device

    def _device_inputs(self, prep: PreparedInputs) -> dict:
        def t(a, dtype=torch.long):
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

        d = {
            "input_ids": t(prep.input_ids),
            "valid": t(prep.valid, torch.bool),
            "position_ids": t(prep.position_ids),
            "patches": t(prep.patches, self.model.dtype),
            "vis_pos_ids": t(prep.vis_pos_ids),
            "full_seg": t(prep.full_seg, torch.int32),
            "vis_valid": t(prep.vis_valid, torch.bool),
            "packed_idx": t(prep.packed_idx),
            "img_slots": t(prep.img_slots),
            "img_valid": t(prep.img_valid, torch.bool),
            "img_group": t(prep.img_group),
            "fuser_window_index": t(prep.fuser.window_index),
            "fuser_reverse_index": t(prep.fuser.reverse_index),
            "fuser_segment_ids": t(prep.fuser.segment_ids, torch.int32),
            "fuser_pos_ids": t(prep.fuser.pos_ids),
        }
        d["le_start"] = None if prep.le_start is None else t(prep.le_start)
        d["anchor_mask"] = None if prep.anchor_mask is None else t(prep.anchor_mask, torch.bool)
        return d

    def _vision(self, inputs: dict, prep: PreparedInputs):
        return self.model.vision_encode(inputs["patches"], inputs["vis_pos_ids"],
                                        inputs["full_seg"], inputs["vis_valid"],
                                        dense_attn=_vis_dense_hint(prep))

    @torch.inference_mode()
    def glimpse(self, prep: PreparedInputs) -> GlimpseOutputs:
        """The pruned prefill: ViT, glimpse encode, keep policy, compaction
        and the remaining layers over the survivors."""
        inputs = self._device_inputs(prep)
        merged, taps = self._vision(inputs, prep)
        return self.model.glimpse_prefill(
            prep.out_len, anchor_mask=inputs["anchor_mask"],
            input_ids=inputs["input_ids"], valid=inputs["valid"],
            position_ids=inputs["position_ids"], image_embeds=merged, taps=taps,
            packed_idx=inputs["packed_idx"], img_slots=inputs["img_slots"],
            img_valid=inputs["img_valid"],
            fuser_window_index=inputs["fuser_window_index"],
            fuser_reverse_index=inputs["fuser_reverse_index"],
            fuser_segment_ids=inputs["fuser_segment_ids"],
            fuser_pos_ids=inputs["fuser_pos_ids"], le_start=inputs["le_start"],
            img_group=inputs["img_group"],
        )

    @torch.inference_mode()
    def prefill(self, prep: PreparedInputs, do_selection: bool = True) -> PrefillResult:
        """Pruned (do_selection) or unpruned prefill up to the first logits."""
        if do_selection:
            out = self.glimpse(prep)
            return PrefillResult(out.logits, out.valid, out.position_ids, out.kv_k,
                                 out.kv_v, out.keep_img, out.mask_logits)
        inputs = self._device_inputs(prep)
        merged, _ = self._vision(inputs, prep)
        ids, valid, pos = inputs["input_ids"], inputs["valid"], inputs["position_ids"]
        gp = self.cfg.gp
        le_len = gp.le_length if gp.has_le else 0
        if le_len:  # the unpruned model has no glimpse slots; they are trailing
            ids, valid, pos = ids[:, :-le_len], valid[:, :-le_len], pos[:, :, :-le_len]
        # generation reads only the last position's logits
        logits, kv_k, kv_v = self.model.vanilla_prefill(
            ids, valid, pos, merged, inputs["packed_idx"], inputs["img_slots"],
            inputs["img_valid"], logits_last_only=True)
        return PrefillResult(logits, valid, pos, kv_k, kv_v, None, None)

    @torch.inference_mode()
    def generate(self, prep: PreparedInputs, max_new_tokens: int = 128,
                 do_selection: bool = True, eos_token_id: Optional[int] = None,
                 stop_sequences: Optional[Sequence[Sequence[int]]] = None) -> GenerateResult:
        """Greedy generation after the pruned (do_selection) or unpruned
        prefill. stop_sequences: token-id sequences; a matched row stops and
        is trimmed before the match (plain eos is trimmed inclusively)."""
        eos = self.cfg.eos_token_id if eos_token_id is None else eos_token_id
        pre = self.prefill(prep, do_selection)
        seqs, n_gen = self._decode_loop(pre.logits, pre.valid, pre.position_ids, pre.kv_k,
                                        pre.kv_v, max_new_tokens, eos, stop_sequences)
        keep_img = mask_logits = prune_ratio = None
        if do_selection:
            keep_img = pre.keep_img.cpu().numpy()
            mask_logits = pre.mask_logits.float().cpu().numpy()
            prune_ratio = 1.0 - keep_img.sum(1) / np.maximum(prep.n_img_tokens, 1)
        return GenerateResult(sequences=seqs, num_generated=n_gen, keep_img=keep_img,
                              mask_logits=mask_logits, prune_ratio=prune_ratio)

    def _decode_loop(self, logits, r_valid, r_pos, kv_k, kv_v, max_new_tokens, eos,
                     stop_sequences=None):
        seqs = self._run_decode(logits, r_valid, r_pos, kv_k, kv_v, max_new_tokens, eos,
                                stop_sequences)
        return self._trim_eos(seqs, max_new_tokens, eos, stop_sequences)

    @staticmethod
    def _first_stop_match(row: np.ndarray, stop_sequences) -> int:
        """Earliest start index of any stop id-sequence in row, or -1."""
        best = -1
        for seq in stop_sequences:
            seq = np.asarray(seq, dtype=row.dtype)
            n = len(seq)
            if n == 0 or n > len(row):
                continue
            win = np.lib.stride_tricks.sliding_window_view(row, n)
            hits = np.nonzero((win == seq).all(axis=1))[0]
            if len(hits) and (best < 0 or hits[0] < best):
                best = int(hits[0])
        return best

    def _trim_eos(self, seqs, max_new_tokens, eos, stop_sequences=None):
        """Everything after the first eos (inclusive) or before the first
        stop sequence (exclusive) becomes eos; counts generated tokens."""
        seqs = seqs[:, :max_new_tokens]
        n_gen = np.zeros((seqs.shape[0],), dtype=np.int64)
        for b in range(seqs.shape[0]):
            hits = np.nonzero(seqs[b] == eos)[0]
            end = int(hits[0]) + 1 if len(hits) else max_new_tokens
            if stop_sequences:
                s = self._first_stop_match(seqs[b, :end], stop_sequences)
                if s >= 0:
                    end = s
            n_gen[b] = end
            seqs[b, end:] = eos
        return seqs, n_gen

    def _run_decode(self, logits, r_valid, r_pos, kv_k, kv_v, max_new_tokens, eos,
                    stop_sequences=None) -> np.ndarray:
        """Greedy decode over the prefill's KV -> seqs [B, n_chunks * chunk]
        (token emitted at each step; eos once a row is done)."""
        model, text = self.model, self.model.text
        b, r = r_valid.shape
        chunk = max(1, min(DECODE_CHUNK, max_new_tokens))
        n_steps = -(-max_new_tokens // chunk) * chunk
        t = r + n_steps
        shape = (kv_k.shape[0], b, t) + tuple(kv_k.shape[3:])
        k_cache = cache_set_prefix(alloc_cache(shape, kv_k.dtype, self.device), kv_k)
        v_cache = cache_set_prefix(alloc_cache(shape, kv_v.dtype, self.device), kv_v)
        kv_valid = torch.cat([r_valid, torch.zeros((b, n_steps), dtype=torch.bool,
                                                   device=self.device)], dim=1)
        last_pos = r_pos[:, :, -1]  # [3, B]
        tok = logits[:, -1].argmax(-1)
        done = tok == eos
        toks = torch.full((b, n_steps), eos, dtype=torch.long, device=self.device)
        seqs = np.full((b, n_steps), eos, dtype=np.int64)
        for step in range(n_steps):
            widx = r + step
            cos, sin = model._cos_sin((last_pos + 1 + step)[:, :, None])
            kv_valid[:, widx] = True
            x = text.embed(tok[:, None])
            for layer_idx, layer in enumerate(text.layers):
                x = layer.decode(layer_idx, x, cos, sin, k_cache, v_cache, kv_valid, widx)
            nxt = text.logits(text.final_norm(x))[:, -1].argmax(-1)
            nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            toks[:, step] = tok  # the token emitted at this step
            done = done | (nxt == eos)
            tok = nxt
            if (step + 1) % chunk == 0:
                seqs[:, :step + 1] = toks[:, :step + 1].cpu().numpy()
                finished = done.cpu().numpy()
                if stop_sequences:  # a matched row counts as done
                    finished = finished | np.array([
                        self._first_stop_match(seqs[i, :step + 1], stop_sequences) >= 0
                        for i in range(b)])
                if finished.all():
                    break
        return seqs

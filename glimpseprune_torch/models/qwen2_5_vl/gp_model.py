"""Qwen2.5-VL + GlimpsePrune: vision, glimpse prefill, keep policy,
compaction, the remaining layers, and the unpruned comparator.

Counterpart of glimpseprune_tpu/models/qwen2_5_vl/gp_model.py:
``vision_encode``, ``_le_vectors_all`` :183, ``_le_geometry`` :198,
``glimpse_encode`` :208 (with its training outputs: every fuser layer's
logits and the answer loss ``le_loss``, :286-302, and the oracle masks of
``use_ref_masks`` / ``gp.use_zero_masks``, :241-262, :306-310),
``reduce_and_resume`` :358 (``gp.per_image_policy`` :370), ``glimpse_prefill``
:434, the baseline compressors' staged in-LLM drop ``staged_prefill`` :444
and full-depth ``prefill_embeds`` :612, ``vanilla_prefill`` :533, the GRPO
teacher-forcing forwards ``completion_logits`` :551, ``completion_logprobs``
:570 and ``text_prefill_logits`` :597, ``decode_chunk`` :624, ``decode_step``
:710, ``embed_with_images`` :721 and ``prefill_chunk`` :735; ``DecodeState.admit``
is the continuous batcher's admission (JAX serving.py:101-121). The row
scatters and gathers (:105-132) are index operations here, not the JAX
package's one-hot matmuls.

Decode: ``decode_state_step`` is one step of JAX ``decode_chunk``'s scan,
written on the device tensors of a ``DecodeState`` only (a 0-d step
counter, the write slot and the positions derived from it on the device),
so that one CUDA graph captured over it (decode_graph.py, the runner's
path on the card) replays every step of every chunk. ``decode_chunk`` runs
it eagerly, n_steps times.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Union

import torch
from torch import nn

from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.gp.fuser import make_fuser
from glimpseprune_torch.models.layers import LayerNorm, Linear, RMSNorm, attach_lora
from glimpseprune_torch.models.qwen2_5_vl.language import TextDecoder
from glimpseprune_torch.models.qwen2_5_vl.vision import VisionTransformer
from glimpseprune_torch.ops.compaction import (
    compaction_indices,
    gather_kv,
    gather_positions,
    gather_tokens,
)
from glimpseprune_torch.ops.keep_policy import (
    descending_rank,
    keep_scores_with_policy,
    keep_scores_with_policy_grouped,
)
from glimpseprune_torch.ops.kv_cache import Cache, cache_fill_rows, cache_t
from glimpseprune_torch.ops.rope import mrope_cos_sin


class GlimpseState(NamedTuple):
    """What the keep policy and the remaining layers need after encode (a
    delayed selection's state, JAX gp_model.py:61-76)."""

    input_ids: torch.Tensor     # [B, S]
    embeds: torch.Tensor        # [B, S, H] layer-0 embeddings (GRPO teacher-forces over them)
    hidden: torch.Tensor        # [B, S, H] after reduce_layer
    kv_k: torch.Tensor          # [n_red, B, S, Hkv, D]
    kv_v: torch.Tensor
    valid: torch.Tensor         # [B, S] (the glimpse slots cleared under use_ref_masks)
    position_ids: torch.Tensor  # [3, B, S]
    keep_base: torch.Tensor     # [B, S] text-keep mask (valid minus le slots)
    img_slots: torch.Tensor     # [B, N]
    img_valid: torch.Tensor     # [B, N]
    img_group: Optional[torch.Tensor]  # [B, N] image index of each slot (multi-image rows)


class GlimpseOutputs(NamedTuple):
    logits: torch.Tensor        # [B, 1, V] last position
    input_ids: torch.Tensor     # [B, R]
    embeds: torch.Tensor        # [B, R, H] the kept layer-0 embeddings
    valid: torch.Tensor         # [B, R]
    position_ids: torch.Tensor  # [3, B, R]
    kv_k: torch.Tensor          # [L, B, R, Hkv, D]
    kv_v: torch.Tensor
    mask_logits: torch.Tensor   # [n_out, B, N]
    keep_img: torch.Tensor      # [B, N]
    le_loss: Optional[torch.Tensor] = None


def sample_next(logits: torch.Tensor, temperature: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The next token from logits [B, V]: the argmax, or with a temperature
    (0-d) the Gumbel-max sample argmax(logits / T + g), g = -log(-log u) of
    uniform draws noise [B, V], which is a draw from softmax(logits / T)
    (JAX ``jax.random.categorical``, runner.py:1146-1148)."""
    if temperature is None:
        return logits.argmax(-1)
    return (logits.float() / temperature - torch.log(-torch.log(noise))).argmax(-1)


@dataclass
class DecodeState:
    """What one decode step reads and writes in place, every field a tensor
    on the model's device: a step reads no Python value that changes from
    step to step, so one captured step serves every step and chunk."""

    k_cache: Cache                 # [L, B, T, Hkv, D], either tier of ops/kv_cache.py
    v_cache: Cache
    kv_valid: torch.Tensor         # [B, T]
    toks: torch.Tensor             # [B, n]: toks[:, s] is the token fed at step s
    tok: torch.Tensor              # [B] the next token to feed
    done: torch.Tensor             # [B]
    step: torch.Tensor             # 0-d, steps taken
    last_pos: torch.Tensor         # [3, B] the prefix's last positions
    write_start: torch.Tensor      # 0-d, the slot step 0 writes
    eos: torch.Tensor              # 0-d
    temperature: Optional[torch.Tensor] = None  # 0-d fp32; None: greedy
    noise: Optional[torch.Tensor] = None        # [B, V] fp32 uniform draws of one step

    @classmethod
    def alloc(cls, k_cache: Cache, v_cache: Cache, n_toks: int, vocab: int, sampled: bool,
              kv_valid: Optional[torch.Tensor] = None) -> "DecodeState":
        """Buffers for a decode over the given caches (and kv_valid [B, T],
        or a new one) that records n_toks tokens; ``begin`` sets them."""
        lead = k_cache["q"] if isinstance(k_cache, dict) else k_cache
        b, t, dev = lead.shape[1], cache_t(k_cache), lead.device

        def long(*shape):
            return torch.zeros(shape, dtype=torch.long, device=dev)

        if kv_valid is None:
            kv_valid = torch.zeros((b, t), dtype=torch.bool, device=dev)
        return cls(k_cache, v_cache, kv_valid, long(b, n_toks), long(b),
                   torch.zeros(b, dtype=torch.bool, device=dev), long(), long(3, b), long(),
                   long(),
                   torch.ones((), device=dev) if sampled else None,
                   torch.full((b, vocab), 0.5, device=dev) if sampled else None)

    def begin(self, first_token: torch.Tensor, last_pos: torch.Tensor,
              write_start: Union[int, torch.Tensor], eos: int, temperature: float = 0.0):
        """Start a decode at step 0 from first_token [B] (kv_valid and the
        caches are the caller's to set)."""
        self.tok.copy_(first_token)
        self.done.copy_(first_token == eos)
        self.step.zero_()
        self.last_pos.copy_(last_pos)
        self.write_start.fill_(write_start)
        self.eos.fill_(eos)
        if self.temperature is not None:
            self.temperature.fill_(temperature)

    def admit(self, slot: int, kv_k: torch.Tensor, kv_v: torch.Tensor, r_valid: torch.Tensor,
              logits: torch.Tensor, r_pos: torch.Tensor, gstep: int, temperature: float = 0.0,
              rng: Optional[torch.Generator] = None) -> None:
        """Admit one request's B=1 prefill into row ``slot`` of a decode
        whose ``step`` counts global steps (JAX serving.py:101-121
        ``_admit``), on device tensors only: its kv [L, 1, R, Hkv, D] fills
        slots [0, R) (``cache_fill_rows``, which quantizes under the int8
        tier), the slot's whole kv_valid lane is cleared (other rows' steps
        have set bits in it) before its first R entries take r_valid [1,
        R], the first token is the argmax of the last logits or, with a
        temperature, a Gumbel-max sample from rng (the same draw as
        ``runner.decode_steps``), done restarts from it, and last_pos
        holds the row's base r_pos[:, 0, -1] - gstep, so that the global
        step at which the row was admitted feeds position r_pos[:, 0, -1]
        + 1."""
        r = r_valid.shape[1]
        cache_fill_rows(self.k_cache, kv_k, slot)
        cache_fill_rows(self.v_cache, kv_v, slot)
        self.kv_valid[slot] = False
        self.kv_valid[slot, :r] = r_valid[0]
        last = logits[:, -1]
        noise = (torch.rand(last.shape, generator=rng, device=last.device)
                 if temperature > 0 else None)
        first = sample_next(last, temperature if temperature > 0 else None, noise)[0]
        self.tok[slot] = first
        self.done[slot] = first == self.eos
        self.last_pos[:, slot] = r_pos[:, 0, -1] - gstep

    def draw_noise(self, rng: Optional[torch.Generator]) -> None:
        """One step's uniform draws from rng (sampling only): one launch,
        outside a captured step, which then holds no generator state."""
        if self.noise is not None:
            self.noise.uniform_(generator=rng)


def _scatter_rows(dest: torch.Tensor, slots: torch.Tensor, src: torch.Tensor,
                  slot_valid: torch.Tensor) -> torch.Tensor:
    """dest [B, S, ...] with src [B, N, ...] written at slots [B, N] where
    slot_valid; a new tensor, invalid slots leave dest's values."""
    out = dest.clone()
    bidx = torch.arange(dest.shape[0], device=dest.device)[:, None].expand_as(slots)
    out[bidx[slot_valid], slots[slot_valid]] = src[slot_valid].to(dest.dtype)
    return out


def _gather_rows(src: torch.Tensor, slots: torch.Tensor,
                 slot_valid: torch.Tensor) -> torch.Tensor:
    """src [B, S, ...] -> [B, N, ...] at slots; invalid slots get 0."""
    out = src[torch.arange(src.shape[0], device=src.device)[:, None], slots]
    sv = slot_valid.reshape(slot_valid.shape + (1,) * (src.ndim - 2))
    return torch.where(sv, out, torch.zeros((), dtype=src.dtype, device=src.device))


def _gather_packed(packed: torch.Tensor, packed_idx: torch.Tensor,
                   img_valid: torch.Tensor) -> torch.Tensor:
    """Packed rows [Pm, H] -> per-row [B, N, H] at packed_idx; invalid -> 0."""
    zero = torch.zeros((), dtype=packed.dtype, device=packed.device)
    return torch.where(img_valid[..., None], packed[packed_idx], zero)


class Qwen2_5_VL_GP(nn.Module):
    """Visual tower + text decoder + the GlimpsePrune modules. A model
    family subclasses it for its own vision side (``_init_vision``,
    ``_bind_vision``, ``vision_encode``); the rest is shared."""

    model_family = "qwen2_5_vl"

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = c = cfg
        self._init_vision()
        self.text = TextDecoder(c.text)
        if c.text.lora_rank > 0:  # zero adapters: the JAX init's LoRA slots
            attach_lora([m for m in self.text.layers.modules() if isinstance(m, Linear)],
                        c.text.lora_rank)
        self.attn_fuser = make_fuser(c)
        if c.gp.has_le:
            self.learnable_embeddings = nn.Parameter(
                torch.zeros(len(c.gp.le_layers), c.gp.le_length, c.text.hidden_size))
            self.le_proj = Linear(c.text.hidden_size, c.text.hidden_size)
            if c.gp.le_norm_type == "rmsnorm":
                self.le_norm = RMSNorm(c.text.hidden_size, c.text.rms_norm_eps)
            elif c.gp.le_norm_type == "layernorm":  # flax nn.LayerNorm: eps 1e-6
                self.le_norm = LayerNorm(c.text.hidden_size)
            else:
                raise ValueError(f"Unsupported le_norm_type {c.gp.le_norm_type!r}")

    def _init_vision(self) -> None:
        self.visual = VisionTransformer(self.cfg.vision,
                                        tap_layers=self.cfg.gp.selected_visual_layers)

    @property
    def dtype(self) -> torch.dtype:
        return self.text.embed_tokens.weight.dtype

    def set_config(self, cfg: ModelConfig) -> "Qwen2_5_VL_GP":
        """Bind the model and every submodule that holds a part of its
        config to cfg, so that the knobs read at run time (the W8A8 and
        int8-attention tiers, remat, the GlimpsePrune knobs) are cfg's.
        The model's config has this one owner: ``quantize_model(...,
        cfg=...)`` calls it once, and a runner refuses a model bound to a
        config other than its own. The weights must already fit cfg."""
        self.cfg = cfg
        self._bind_vision(cfg)
        self.text.cfg = cfg.text
        for layer in self.text.layers:
            layer.cfg = cfg.text
        self.attn_fuser.gp = cfg.gp
        return self

    def _bind_vision(self, cfg: ModelConfig) -> None:
        self.visual.cfg = cfg.vision
        for block in self.visual.blocks:
            block.cfg = cfg.vision

    def vision_weight_tier(self, cfg: ModelConfig) -> str:
        """The tier the vision tower's weights must be in under cfg."""
        return cfg.vision.weight_quant

    def _cos_sin(self, position_ids):
        t = self.cfg.text
        cos, sin = mrope_cos_sin(position_ids, t.head_dim, t.rope_theta, t.mrope_section)
        return cos.to(self.dtype), sin.to(self.dtype)

    # ---- vision

    def vision_encode(self, patches, pos_ids, full_seg, vis_valid, dense_attn: bool = False,
                      emit_importance: bool = False):
        """Window-padded packed patches -> (merged embeds, taps[, importance])
        in slot order; importance as in ``VisionTransformer.forward``."""
        return self.visual(patches, pos_ids, full_seg, vis_valid, dense_attn=dense_attn,
                           emit_importance=emit_importance)

    # ---- glimpse embeddings

    def _le_vectors_all(self, training: bool = False,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Projected glimpse embeddings at their layers -> [L, le_len, H],
        zeros at layers without one. In training, dropout with
        ``gp.le_dropout_prob`` draws its mask from ``generator`` (flax
        ``nn.Dropout``: keep with 1 - p, scale kept values by 1 / (1 - p))."""
        gp = self.cfg.gp
        le = self.le_norm(self.le_proj(self.learnable_embeddings.to(self.dtype)))
        p = gp.le_dropout_prob
        if training and p > 0.0:
            keep = torch.rand(le.shape, generator=generator, device=le.device) >= p
            le = torch.where(keep, le / (1.0 - p), torch.zeros((), dtype=le.dtype,
                                                                device=le.device))
        zeros = torch.zeros((self.cfg.text.num_hidden_layers,) + le.shape[1:],
                            dtype=le.dtype, device=le.device)
        return zeros.index_copy(0, torch.as_tensor(gp.le_layers, device=le.device), le)

    @staticmethod
    def _le_geometry(le_start: torch.Tensor, s: int, le_length: int):
        """(offset [B, S] clipped index into le_len, inside [B, S] bool)."""
        offset = torch.arange(s, device=le_start.device)[None, :] - le_start[:, None]
        inside = (offset >= 0) & (offset < le_length)
        return offset.clamp(0, le_length - 1), inside

    def embed_with_images(self, input_ids, image_embeds=None, packed_idx=None, img_slots=None,
                          img_valid=None):
        """Token embeddings with the image rows scattered in (JAX :704-716);
        image_embeds None gives text-only rows. Nothing here is trained, so
        autograd records none of it."""
        with torch.no_grad():
            embeds = self.text.embed(input_ids)
            if image_embeds is None:
                return embeds
            rows = _gather_packed(image_embeds, packed_idx, img_valid)
            return _scatter_rows(embeds, img_slots, rows, img_valid)

    # ---- glimpse prefill, phase 1: encode + predict mask logits

    def glimpse_encode(self, input_ids, valid, position_ids, image_embeds, taps: Sequence,
                       packed_idx, img_slots, img_valid, fuser_window_index,
                       fuser_reverse_index, fuser_segment_ids, fuser_pos_ids,
                       le_start: Optional[torch.Tensor], img_group=None,
                       labels: Optional[torch.Tensor] = None, training: bool = False,
                       generator: Optional[torch.Generator] = None,
                       ref_token_masks: Optional[torch.Tensor] = None,
                       use_ref_masks: bool = False):
        """Layers 0..reduce_layer with the glimpse embeddings injected, the
        glimpse query's harvest at selected_layers, and the fuser's mask
        logits -> (mask_logits [n_out, B, N], GlimpseState, le_loss).

        With ``labels`` [B, S] (-100 where unlabelled), training runs the
        remaining layers too, still with the glimpse embeddings, and
        le_loss is the answer's mean next-token NLL (``chunked_nll``);
        otherwise le_loss is None. ``training`` selects the fuser's training
        outputs and the glimpse-embedding dropout, whose mask comes from
        ``generator``.

        ``use_ref_masks`` (the oracle masks, JAX :224-233, :289-293): no
        glimpse embedding is injected, the reserved glimpse slots become
        invalid (invisible to attention, dropped by the reduction), nothing
        is harvested, and the mask logits are +inf where ``ref_token_masks``
        [B, N] is set, -inf elsewhere. ``gp.use_zero_masks`` gives -inf at
        every slot, so that only the keep policy's floor survives."""
        c, gp = self.cfg, self.cfg.gp
        b, s = input_ids.shape
        embeds = self.embed_with_images(input_ids, image_embeds, packed_idx, img_slots,
                                        img_valid)
        inject_le = gp.has_le and not use_ref_masks and le_start is not None
        le_mask = torch.zeros((b, s), dtype=torch.bool, device=input_ids.device)
        le_vecs = le_offset = le_inside = None
        if gp.has_le and le_start is not None and not inject_le:
            valid = valid & ~self._le_geometry(le_start, s, gp.le_length)[1]
        if inject_le:
            le_vecs = self._le_vectors_all(training, generator)
            le_offset, le_inside = self._le_geometry(le_start, s, gp.le_length)
            le_mask = le_inside
            if 0 in gp.le_layers:  # layer-0 splice: overwrite the placeholder slots
                embeds = torch.where(le_inside[..., None], le_vecs[0][le_offset].to(embeds.dtype),
                                     embeds)
            q_index = le_start + gp.le_length - 1
        else:
            q_index = torch.full((b,), s - 1, dtype=torch.long, device=input_ids.device)

        cos, sin = self._cos_sin(position_ids)
        reduce_layer = min(gp.reduce_layer, c.text.num_hidden_layers - 1)
        predicted = not (use_ref_masks or gp.use_zero_masks)  # the fuser predicts the masks
        x, (kv_k, kv_v), harvests = self.text.run_layers(
            embeds, cos, sin, valid, layer_start=0, layer_end=reduce_layer,
            le_vecs=le_vecs, le_offset=le_offset, le_inside=le_inside,
            harvest_layers=tuple(gp.selected_layers) if predicted else (), q_index=q_index,
            use_attention_logits=gp.use_attention_logits,
        )
        le_loss = None
        if labels is not None:  # training runs every layer for the answer loss
            h = x
            if reduce_layer < c.text.num_hidden_layers - 1:
                h, _, _ = self.text.run_layers(
                    h, cos, sin, valid, layer_start=reduce_layer + 1, le_vecs=le_vecs,
                    le_offset=le_offset, le_inside=le_inside, collect_kv=False)
            le_loss = self.text.chunked_nll(self.text.final_norm(h), labels)
        if use_ref_masks:
            if ref_token_masks is None:
                raise ValueError("use_ref_masks needs ref_token_masks (the prep's bboxes)")
            inf = torch.tensor(float("inf"), device=img_valid.device)
            mask_logits = torch.where(ref_token_masks, inf, -inf)[None]
        elif gp.use_zero_masks:
            mask_logits = torch.full((1,) + tuple(img_valid.shape), -float("inf"),
                                     device=img_valid.device)
        else:
            attn_map = torch.stack([harvests[l] for l in gp.selected_layers], dim=2)
            # log-softmax rows hold -inf at masked slots; the gathered image
            # slots are finite, the clamp keeps the gather free of -inf (:319)
            attn_map = attn_map.reshape(b, s, -1).clamp(min=-1e30)
            attn_map = _gather_rows(attn_map, img_slots, img_valid)
            taps_rows = [_gather_packed(t, packed_idx, img_valid) for t in taps]
            mask_logits = self.attn_fuser(attn_map, taps_rows, fuser_window_index,
                                          fuser_reverse_index, fuser_segment_ids,
                                          fuser_pos_ids, img_valid, group_ids=img_group,
                                          training=training, dtype=self.dtype)
        state = GlimpseState(input_ids=input_ids, embeds=embeds, hidden=x, kv_k=kv_k,
                             kv_v=kv_v, valid=valid, position_ids=position_ids,
                             keep_base=valid & ~le_mask, img_slots=img_slots,
                             img_valid=img_valid, img_group=img_group)
        return mask_logits, state, le_loss

    # ---- phase 2: keep policy + compaction + remaining layers

    def reduce_and_resume(self, state: GlimpseState, mask_logits: torch.Tensor,
                          out_len: int, anchor_mask=None) -> GlimpseOutputs:
        """The keep policy on the last mask logits (per image with
        ``gp.per_image_policy`` on multi-image rows, JAX :369-384), the
        compaction of the state to out_len slots and the remaining layers
        over them."""
        c, gp = self.cfg, self.cfg.gp
        probs = torch.sigmoid(mask_logits[-1].float())
        if gp.per_image_policy and state.img_group is not None:
            keep_img = keep_scores_with_policy_grouped(
                probs, state.img_valid, state.img_group, gp.reduce_threshold,
                gp.max_remain_ratio, gp.min_remain_num, anchor_mask)
        else:
            keep_img = keep_scores_with_policy(probs, state.img_valid, gp.reduce_threshold,
                                               gp.max_remain_ratio, gp.min_remain_num,
                                               anchor_mask)
        keep = _scatter_rows(state.keep_base, state.img_slots, keep_img, state.img_valid)
        plan = compaction_indices(keep, out_len)
        r_ids = gather_tokens(state.input_ids, plan, fill=c.pad_token_id)
        r_embeds = gather_tokens(state.embeds, plan)
        r_pos = gather_positions(state.position_ids, plan)
        r_k = gather_kv(state.kv_k, plan)
        r_v = gather_kv(state.kv_v, plan)
        x = gather_tokens(state.hidden, plan)
        reduce_layer = min(gp.reduce_layer, c.text.num_hidden_layers - 1)
        if reduce_layer < c.text.num_hidden_layers - 1:
            cos, sin = self._cos_sin(r_pos)
            x, (k2, v2), _ = self.text.run_layers(x, cos, sin, plan.valid,
                                                  layer_start=reduce_layer + 1)
            r_k = torch.cat([r_k, k2])
            r_v = torch.cat([r_v, v2])
        logits = self.text.logits(self.text.final_norm(x[:, -1:]))
        return GlimpseOutputs(logits=logits, input_ids=r_ids, embeds=r_embeds,
                              valid=plan.valid, position_ids=r_pos, kv_k=r_k, kv_v=r_v,
                              mask_logits=mask_logits, keep_img=keep_img)

    def glimpse_prefill(self, out_len: int, anchor_mask=None, **encode_kwargs) -> GlimpseOutputs:
        mask_logits, state, le_loss = self.glimpse_encode(**encode_kwargs)
        out = self.reduce_and_resume(state, mask_logits, out_len, anchor_mask)
        return out._replace(le_loss=le_loss)

    # ---- staged in-LLM dropping (PyramidDrop) and compressed sequences

    def staged_prefill(self, input_ids, valid, position_ids, image_embeds, packed_idx,
                       img_slots, img_valid, stages: Sequence, out_lens: Sequence[int]):
        """Text-guided staged image-token dropping (compressors/staged.py).

        At each (layer, ratio) stage: run the layers up to it, harvest the
        last token's attention row at that layer, keep the top
        max(int(ratio * n_img), 1) image tokens of each row, and compact the
        hidden state and the KV accumulated so far to out_len slots. Returns
        (logits [B, 1, V], ids, valid, position_ids, kv_k, kv_v, is_img) on
        the final compacted geometry."""
        c = self.cfg
        b = input_ids.shape[0]
        x = self.embed_with_images(input_ids, image_embeds, packed_idx, img_slots, img_valid)
        is_img = _scatter_rows(torch.zeros_like(valid), img_slots, img_valid, img_valid)
        pos = position_ids
        ks, vs = [], []
        cursor = 0
        n_img0 = img_valid.sum(-1)
        for (stage_layer, ratio), out_len in zip(stages, out_lens):
            cos, sin = self._cos_sin(pos)
            q_index = torch.full((b,), x.shape[1] - 1, dtype=torch.long, device=x.device)
            x, (k_seg, v_seg), harv = self.text.run_layers(
                x, cos, sin, valid, layer_start=cursor, layer_end=stage_layer,
                harvest_layers=(stage_layer,), q_index=q_index, use_attention_logits=False)
            ks.append(k_seg)
            vs.append(v_seg)
            cursor = stage_layer + 1
            probs = harv[stage_layer].float().exp().mean(-1)  # [B, S]
            rank = descending_rank(probs, is_img & valid)
            k_keep = (ratio * n_img0).to(torch.int32).clamp(min=1)
            keep = (valid & ~is_img) | ((rank < k_keep[:, None]) & is_img & valid)
            plan = compaction_indices(keep, out_len)
            x = gather_tokens(x, plan)
            input_ids = gather_tokens(input_ids, plan, fill=c.pad_token_id)
            pos = gather_positions(pos, plan)
            is_img = gather_tokens(is_img, plan, fill=False)
            valid = plan.valid
            ks = [gather_kv(torch.cat(ks), plan)]
            vs = [gather_kv(torch.cat(vs), plan)]
        if cursor < c.text.num_hidden_layers:
            cos, sin = self._cos_sin(pos)
            x, (k_seg, v_seg), _ = self.text.run_layers(x, cos, sin, valid, layer_start=cursor)
            ks.append(k_seg)
            vs.append(v_seg)
        logits = self.text.logits(self.text.final_norm(x[:, -1:]))
        return logits, input_ids, valid, pos, torch.cat(ks), torch.cat(vs), is_img

    def prefill_embeds(self, embeds, valid, position_ids):
        """Full-depth prefill over precomputed embeddings (a compressed
        sequence) -> (last position's logits, kv_k, kv_v)."""
        cos, sin = self._cos_sin(position_ids)
        x, (kv_k, kv_v), _ = self.text.run_layers(embeds, cos, sin, valid)
        return self.text.logits(self.text.final_norm(x[:, -1:])), kv_k, kv_v

    # ---- teacher forcing (the GRPO policy and reference forwards)

    def _teacher_forced(self, prompt_embeds, prompt_valid, prompt_pos, completion_ids,
                        completion_valid, completion_pos) -> torch.Tensor:
        """Every layer over [prompt embeds ; completion tokens] -> the hidden
        state after the final norm [B, R + T, H]."""
        embeds = torch.cat([prompt_embeds, self.text.embed(completion_ids)], 1)
        valid = torch.cat([prompt_valid, completion_valid], 1)
        cos, sin = self._cos_sin(torch.cat([prompt_pos, completion_pos], 2))
        x, _, _ = self.text.run_layers(embeds, cos, sin, valid, collect_kv=False)
        return self.text.final_norm(x)

    def completion_logits(self, prompt_embeds, prompt_valid, prompt_pos, completion_ids,
                          completion_valid, completion_pos) -> torch.Tensor:
        """Logits [B, R + T, V] of teacher forcing over the pruned prompt's
        embeddings [B, R, H] and the completion ids [B, T] (JAX :551-568)."""
        return self.text.logits(self._teacher_forced(
            prompt_embeds, prompt_valid, prompt_pos, completion_ids, completion_valid,
            completion_pos))

    def completion_logprobs(self, prompt_embeds, prompt_valid, prompt_pos, completion_ids,
                            completion_valid, completion_pos) -> torch.Tensor:
        """log p(completion token) [B, T] fp32 under teacher forcing (JAX
        :570-595): the head runs on the T positions that predict the
        completion only, in chunks (``chunked_token_logprobs``), so no
        [B, T, V] logits are kept."""
        x = self._teacher_forced(prompt_embeds, prompt_valid, prompt_pos, completion_ids,
                                 completion_valid, completion_pos)
        r = prompt_embeds.shape[1]  # the hidden state at r - 1 predicts token 0
        return self.text.chunked_token_logprobs(x[:, r - 1:-1], completion_ids)

    def text_prefill_logits(self, input_ids, valid, position_ids) -> torch.Tensor:
        """Logits [B, S, V] of teacher forcing over a token sequence, every
        position projected (JAX :597-610)."""
        cos, sin = self._cos_sin(position_ids)
        x, _, _ = self.text.run_layers(self.text.embed(input_ids), cos, sin, valid,
                                       collect_kv=False)
        return self.text.logits(self.text.final_norm(x))

    # ---- decode

    def decode_step(self, input_ids, position_ids, k_cache, v_cache, kv_valid, write_idx):
        """input_ids [B, S_new] at position_ids [3, B, S_new] against the
        cache (JAX :693): -> (logits [B, S_new, V], k_cache, v_cache), the
        caches read, then written in place at write_idx."""
        cos, sin = self._cos_sin(position_ids)
        return self.text.decode_step(input_ids, cos, sin, k_cache, v_cache, kv_valid,
                                     write_idx)

    def prefill_chunk(self, chunk_embeds, position_ids, k_cache, v_cache, kv_valid,
                      write_idx, chunk_valid, logit_index):
        """One chunked-prefill step (JAX :718-734): C token embeddings
        chunk_embeds [B, C, H] (image rows scattered in) at position_ids
        [3, B, C] against the partly filled cache, written at write_idx..;
        chunk_valid [B, C] masks the chunk's pads as keys. -> (logits [B,
        1, V] at chunk slot logit_index, the only slot the head runs on,
        k_cache, v_cache)."""
        cos, sin = self._cos_sin(position_ids)
        return self.text.decode_step(None, cos, sin, k_cache, v_cache, kv_valid, write_idx,
                                     inputs_embeds=chunk_embeds, logits_index=logit_index,
                                     new_valid=chunk_valid)

    def decode_state_step(self, st: DecodeState) -> torch.Tensor:
        """One decode step on st, in place, on device tensors only (JAX
        ``decode_chunk``'s scan body, :644-686): the slot write_start + step
        becomes valid, the fed token runs through every layer at position
        last_pos + 1 + step, the next token is the argmax or a sample (eos
        once a row is done), the fed token is recorded at toks[:, step].
        Returns the step's logits [B, V]."""
        widx = st.write_start + st.step
        cos, sin = self._cos_sin((st.last_pos + 1 + st.step)[:, :, None])
        st.kv_valid.index_fill_(1, widx.reshape(1), True)
        logits = self.text.decode_step(st.tok[:, None], cos, sin, st.k_cache, st.v_cache,
                                       st.kv_valid, widx)[0][:, -1]
        nxt = torch.where(st.done, st.eos, sample_next(logits, st.temperature, st.noise))
        st.toks.index_copy_(1, st.step.reshape(1), st.tok[:, None])
        st.done.logical_or_(nxt == st.eos)
        st.tok.copy_(nxt)
        st.step.add_(1)
        return logits

    def decode_chunk(self, first_token, last_pos, k_cache, v_cache, kv_valid, write_start,
                     rng: Optional[torch.Generator], n_steps: int, eos_token_id: int,
                     temperature: float = 0.0):
        """Decode n_steps tokens after first_token [B] (JAX :607-691):
        ``decode_state_step`` run eagerly n_steps times; greedy when
        temperature == 0, else sampled with noise from rng (a
        torch.Generator on the model's device). The caches and kv_valid [B,
        T] are written in place. Returns (toks [B, n_steps], the next token,
        done [B], k_cache, v_cache, kv_valid). The runner replays the same
        step as a CUDA graph on the card (decode_graph.py)."""
        st = DecodeState.alloc(k_cache, v_cache, n_steps, self.cfg.text.vocab_size,
                               temperature > 0, kv_valid)
        st.begin(first_token, last_pos, write_start, eos_token_id, temperature)
        for _ in range(n_steps):
            st.draw_noise(rng)
            self.decode_state_step(st)
        return st.toks, st.tok, st.done, st.k_cache, st.v_cache, st.kv_valid

    # ---- the unpruned comparator

    def vanilla_prefill(self, input_ids, valid, position_ids, image_embeds, packed_idx,
                        img_slots, img_valid, logits_last_only: bool = False):
        """Full-depth prefill over all tokens -> (logits, kv_k, kv_v)."""
        embeds = self.embed_with_images(input_ids, image_embeds, packed_idx, img_slots,
                                        img_valid)
        cos, sin = self._cos_sin(position_ids)
        x, (kv_k, kv_v), _ = self.text.run_layers(embeds, cos, sin, valid)
        x = self.text.final_norm(x[:, -1:] if logits_last_only else x)
        return self.text.logits(x), kv_k, kv_v

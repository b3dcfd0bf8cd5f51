"""Qwen2.5-VL + GlimpsePrune: vision, glimpse prefill, keep policy,
compaction, the remaining layers, and the unpruned comparator.

Counterpart of glimpseprune_tpu/models/qwen2_5_vl/gp_model.py:
``vision_encode``, ``_le_vectors_all`` :166, ``_le_geometry`` :181,
``glimpse_encode`` :191 (with its training outputs: every fuser layer's
logits and the answer loss ``le_loss``, :269-285), ``reduce_and_resume``
:341, ``glimpse_prefill`` :417, ``vanilla_prefill`` :516 and
``embed_with_images`` :704. The row scatters and gathers (:88-115) are index
operations here, not the JAX package's one-hot matmuls.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.gp.fuser import make_fuser
from glimpseprune_torch.models.layers import Linear, RMSNorm
from glimpseprune_torch.models.qwen2_5_vl.language import TextDecoder
from glimpseprune_torch.models.qwen2_5_vl.vision import VisionTransformer
from glimpseprune_torch.ops.compaction import (
    compaction_indices,
    gather_kv,
    gather_positions,
    gather_tokens,
)
from glimpseprune_torch.ops.keep_policy import keep_scores_with_policy
from glimpseprune_torch.ops.rope import mrope_cos_sin


class GlimpseState(NamedTuple):
    """What the keep policy and the remaining layers need after encode."""

    input_ids: torch.Tensor     # [B, S]
    hidden: torch.Tensor        # [B, S, H] after reduce_layer
    kv_k: torch.Tensor          # [n_red, B, S, Hkv, D]
    kv_v: torch.Tensor
    position_ids: torch.Tensor  # [3, B, S]
    keep_base: torch.Tensor     # [B, S] text-keep mask (valid minus le slots)
    img_slots: torch.Tensor     # [B, N]
    img_valid: torch.Tensor     # [B, N]


class GlimpseOutputs(NamedTuple):
    logits: torch.Tensor        # [B, 1, V] last position
    input_ids: torch.Tensor     # [B, R]
    valid: torch.Tensor         # [B, R]
    position_ids: torch.Tensor  # [3, B, R]
    kv_k: torch.Tensor          # [L, B, R, Hkv, D]
    kv_v: torch.Tensor
    mask_logits: torch.Tensor   # [n_out, B, N]
    keep_img: torch.Tensor      # [B, N]


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
    """Visual tower + text decoder + the GlimpsePrune modules."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = c = cfg
        self.visual = VisionTransformer(c.vision, tap_layers=c.gp.selected_visual_layers)
        self.text = TextDecoder(c.text)
        self.attn_fuser = make_fuser(c)
        if c.gp.has_le:
            if c.gp.le_norm_type != "rmsnorm":
                raise ValueError(f"le_norm_type {c.gp.le_norm_type!r} is not ported")
            self.learnable_embeddings = nn.Parameter(
                torch.zeros(len(c.gp.le_layers), c.gp.le_length, c.text.hidden_size))
            self.le_proj = Linear(c.text.hidden_size, c.text.hidden_size)
            self.le_norm = RMSNorm(c.text.hidden_size, c.text.rms_norm_eps)

    @property
    def dtype(self) -> torch.dtype:
        return self.text.embed_tokens.weight.dtype

    def _cos_sin(self, position_ids):
        t = self.cfg.text
        cos, sin = mrope_cos_sin(position_ids, t.head_dim, t.rope_theta, t.mrope_section)
        return cos.to(self.dtype), sin.to(self.dtype)

    # ---- vision

    def vision_encode(self, patches, pos_ids, full_seg, vis_valid, dense_attn: bool = False):
        """Window-padded packed patches -> (merged embeds, taps) in slot order."""
        return self.visual(patches, pos_ids, full_seg, vis_valid, dense_attn=dense_attn)

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

    def embed_with_images(self, input_ids, image_embeds, packed_idx, img_slots, img_valid):
        """Token embeddings with the image rows scattered in. Nothing here
        is trained, so autograd records none of it."""
        with torch.no_grad():
            embeds = self.text.embed(input_ids)
            rows = _gather_packed(image_embeds, packed_idx, img_valid)
            return _scatter_rows(embeds, img_slots, rows, img_valid)

    # ---- glimpse prefill, phase 1: encode + predict mask logits

    def glimpse_encode(self, input_ids, valid, position_ids, image_embeds, taps: Sequence,
                       packed_idx, img_slots, img_valid, fuser_window_index,
                       fuser_reverse_index, fuser_segment_ids, fuser_pos_ids,
                       le_start: Optional[torch.Tensor], img_group=None,
                       labels: Optional[torch.Tensor] = None, training: bool = False,
                       generator: Optional[torch.Generator] = None):
        """Layers 0..reduce_layer with the glimpse embeddings injected, the
        glimpse query's harvest at selected_layers, and the fuser's mask
        logits -> (mask_logits [n_out, B, N], GlimpseState, le_loss).

        With ``labels`` [B, S] (-100 where unlabelled), training runs the
        remaining layers too, still with the glimpse embeddings, and
        le_loss is the answer's mean next-token NLL (``chunked_nll``);
        otherwise le_loss is None. ``training`` selects the fuser's training
        outputs and the glimpse-embedding dropout, whose mask comes from
        ``generator``."""
        c, gp = self.cfg, self.cfg.gp
        b, s = input_ids.shape
        embeds = self.embed_with_images(input_ids, image_embeds, packed_idx, img_slots,
                                        img_valid)
        le_mask = torch.zeros((b, s), dtype=torch.bool, device=input_ids.device)
        le_vecs = le_offset = le_inside = None
        if gp.has_le and le_start is not None:
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
        x, (kv_k, kv_v), harvests = self.text.run_layers(
            embeds, cos, sin, valid, layer_start=0, layer_end=reduce_layer,
            le_vecs=le_vecs, le_offset=le_offset, le_inside=le_inside,
            harvest_layers=tuple(gp.selected_layers), q_index=q_index,
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
        attn_map = torch.stack([harvests[l] for l in gp.selected_layers], dim=2)
        # log-softmax rows hold -inf at masked slots; the gathered image slots
        # are finite, the clamp keeps the gather free of -inf (gp_model.py:302)
        attn_map = attn_map.reshape(b, s, -1).clamp(min=-1e30)
        attn_map = _gather_rows(attn_map, img_slots, img_valid)
        taps_rows = [_gather_packed(t, packed_idx, img_valid) for t in taps]
        mask_logits = self.attn_fuser(attn_map, taps_rows, fuser_window_index,
                                      fuser_reverse_index, fuser_segment_ids,
                                      fuser_pos_ids, img_valid, group_ids=img_group,
                                      training=training, dtype=self.dtype)
        state = GlimpseState(input_ids=input_ids, hidden=x, kv_k=kv_k, kv_v=kv_v,
                             position_ids=position_ids,
                             keep_base=valid & ~le_mask, img_slots=img_slots,
                             img_valid=img_valid)
        return mask_logits, state, le_loss

    # ---- phase 2: keep policy + compaction + remaining layers

    def reduce_and_resume(self, state: GlimpseState, mask_logits: torch.Tensor,
                          out_len: int, anchor_mask=None) -> GlimpseOutputs:
        c, gp = self.cfg, self.cfg.gp
        probs = torch.sigmoid(mask_logits[-1].float())
        keep_img = keep_scores_with_policy(probs, state.img_valid, gp.reduce_threshold,
                                           gp.max_remain_ratio, gp.min_remain_num,
                                           anchor_mask)
        keep = _scatter_rows(state.keep_base, state.img_slots, keep_img, state.img_valid)
        plan = compaction_indices(keep, out_len)
        r_ids = gather_tokens(state.input_ids, plan, fill=c.pad_token_id)
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
        return GlimpseOutputs(logits=logits, input_ids=r_ids, valid=plan.valid,
                              position_ids=r_pos, kv_k=r_k, kv_v=r_v,
                              mask_logits=mask_logits, keep_img=keep_img)

    def glimpse_prefill(self, out_len: int, anchor_mask=None, **encode_kwargs) -> GlimpseOutputs:
        mask_logits, state, _ = self.glimpse_encode(**encode_kwargs)
        return self.reduce_and_resume(state, mask_logits, out_len, anchor_mask)

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

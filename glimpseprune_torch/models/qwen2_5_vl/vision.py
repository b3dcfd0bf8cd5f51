"""Windowed vision transformer (Qwen2.5-VL) with feature taps.

Counterpart of glimpseprune_tpu/models/qwen2_5_vl/vision.py
(``VisionTransformer`` :167, ``_block_fwd`` :92). It runs on the
window-padded packed patch layout that ``prepare_inputs`` builds: windowed
blocks go through the fused rope + window-attention kernel (K1) on the qkv
projection's natural layout, the full-attention blocks through the flash
kernel (K2) with per-image segment ids. Taps are merge-unit means of the
hidden state after the tap blocks, in slot order. The ViT is prefill-only
compute, so either ``act_quant`` tier turns W8A8 on in every block, and
the full-attention blocks run the int8 flash tier (K7) when the tower's
``attn_qk_int8`` / ``attn_pv_int8`` ask for it (JAX :98, :110-114).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from glimpseprune_torch.config import VisionConfig
from glimpseprune_torch.models.layers import GatedMLP, Linear, RMSNorm
from glimpseprune_torch.ops.attention import fused_window_attention, segment_attention
from glimpseprune_torch.ops.rope import apply_rotary, vision_rope_cos_sin


class VisionAttention(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.qkv = Linear(hidden_size, 3 * hidden_size)
        self.proj = Linear(hidden_size, hidden_size)


class VisionBlock(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = RMSNorm(cfg.hidden_size)
        self.norm2 = RMSNorm(cfg.hidden_size)
        self.attn = VisionAttention(cfg.hidden_size)
        self.mlp = GatedMLP(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act, bias=True)

    def forward(self, x, cos, sin, segment_ids, valid, wp: int, dense_attn: bool = False):
        """wp > 0 selects the window path; otherwise full attention over
        segment_ids (dense_attn: one unpadded image, no mask)."""
        c = self.cfg
        p = x.shape[0]
        a8 = c.act_quant in ("int8", "prefill")
        qkv = self.attn.qkv(self.norm1(x), a8).reshape(p, 3, c.num_heads, c.head_dim)
        if wp > 0:
            attn = fused_window_attention(qkv, cos, sin, valid, wp)
        else:
            q = apply_rotary(qkv[:, 0][None], cos[None], sin[None])[0]
            k = apply_rotary(qkv[:, 1][None], cos[None], sin[None])[0]
            attn = segment_attention(q, k, qkv[:, 2], segment_ids, dense=dense_attn,
                                     int8_qk=a8 and c.attn_qk_int8,
                                     int8_pv=a8 and c.attn_pv_int8)
        x = x + self.attn.proj(attn.reshape(p, c.hidden_size), a8)
        return x + self.mlp(self.norm2(x), a8)


class VisionTransformer(nn.Module):
    """Inputs in the window-padded slot layout: patches [P, in_dim],
    pos_ids [P, 2], full_seg [P] (-1 = pad), valid [P]. Returns
    (merged [P // mu, out_hidden], taps [P // mu, hidden] per tap layer)."""

    def __init__(self, cfg: VisionConfig, tap_layers: Sequence[int] = ()):
        super().__init__()
        self.cfg = cfg
        self.tap_layers = tuple(tap_layers)
        in_dim = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2
        mu = cfg.spatial_merge_unit
        self.patch_embed = nn.Linear(in_dim, cfg.hidden_size, bias=False)
        self.blocks = nn.ModuleList(VisionBlock(cfg) for _ in range(cfg.depth))
        self.merger_ln_q = RMSNorm(cfg.hidden_size)
        self.merger_fc1 = nn.Linear(mu * cfg.hidden_size, mu * cfg.hidden_size)
        self.merger_fc2 = nn.Linear(mu * cfg.hidden_size, cfg.out_hidden_size)

    @property
    def window_patches(self) -> int:
        c = self.cfg
        win = c.window_size // c.spatial_merge_size // c.patch_size
        return win * win * c.spatial_merge_unit

    def forward(self, patches, pos_ids, full_seg, valid,
                dense_attn: bool = False) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        c = self.cfg
        mu = c.spatial_merge_unit
        dtype = self.patch_embed.weight.dtype
        x = self.patch_embed(patches.to(dtype))
        cos, sin = vision_rope_cos_sin(pos_ids, c.head_dim)
        cos, sin = cos.to(dtype), sin.to(dtype)
        fullatt = set(c.fullatt_block_indexes)
        taps: List[torch.Tensor] = [None] * len(self.tap_layers)
        for i, block in enumerate(self.blocks):
            x = block(x, cos, sin, full_seg, valid, 0 if i in fullatt else self.window_patches,
                      dense_attn=dense_attn)
            if i in self.tap_layers:
                taps[self.tap_layers.index(i)] = x.reshape(-1, mu, c.hidden_size).mean(1)
        merged = self.merger_ln_q(x).reshape(-1, mu * c.hidden_size)
        merged = self.merger_fc2(F.gelu(self.merger_fc1(merged)))
        return merged, taps

"""Visual-token importance predictor (the AttnFuser family).

Counterpart of glimpseprune_tpu/gp/fuser.py (``_permute`` :109,
``_normalized_mean_attention`` :122, ``CondSdpaAttention`` :159,
``AttnFuserLayer`` :216, ``AttnFuserDummy`` / ``AttnFuserV1`` /
``AttnFuserV2`` :244-327, ``make_fuser``): small transformer heads that fuse
the glimpse token's harvested attention rows, optionally conditioned on ViT
taps, into per-image-token keep logits. Layout [B, N, ...] with per-row
segment ids; the window permutation comes from the host-built
``FuserGeometry`` (models/qwen2_5_vl/inputs.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from glimpseprune_tpu.config import ModelConfig
from glimpseprune_torch.models.layers import GatedMLP, RMSNorm
from glimpseprune_torch.ops.cuda.flash_attention import flash_attention
from glimpseprune_torch.ops.rope import apply_rotary, vision_rope_cos_sin


def _permute(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] permuted along dim 1 by per-row idx [B, N]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _normalized_mean_attention(attn_map: torch.Tensor, valid: torch.Tensor,
                               use_attention_logits: bool,
                               group_ids: Optional[torch.Tensor] = None,
                               max_groups: int = 8) -> torch.Tensor:
    """Training-free importance: per-image min-max-normalized mean attention
    over the harvested rows [B, N, n_layers * n_heads] -> [B, N]."""
    m = attn_map.float().mean(-1)
    if group_ids is None:
        group_ids = torch.zeros(m.shape, dtype=torch.long, device=m.device)
    g = group_ids.long().clamp(0, max_groups - 1)
    member = (torch.arange(max_groups, device=m.device)[None, None, :] == g[..., None]) \
        & valid[..., None]  # [B, N, G]
    inf = torch.tensor(float("inf"), device=m.device)

    def per_element(per_group):  # [B, G] -> [B, N]
        return torch.gather(per_group, 1, g)

    if use_attention_logits:  # softmax within each image's span
        lg = torch.where(valid, m, -inf)
        gmax = torch.where(member, lg[..., None], -inf).amax(1)
        e = torch.where(valid, torch.exp(lg - per_element(gmax)), torch.zeros_like(m))
        denom = torch.where(member, e[..., None], torch.zeros_like(e)[..., None]).sum(1)
        m = e / per_element(denom).clamp(min=1e-30)
    else:
        m = torch.exp(m)  # rows are log-probs
    mmin = per_element(torch.where(member, m[..., None], inf).amin(1))
    mmax = per_element(torch.where(member, m[..., None], -inf).amax(1))
    out = (m - mmin) / (mmax - mmin + 1e-6)
    return torch.where(valid, out, torch.zeros_like(out))


class CondSdpaAttention(nn.Module):
    """Q/K from concat(features, condition), V from the features only."""

    def __init__(self, hidden_size: int, cond_size: int, num_heads: int):
        super().__init__()
        qk_size = hidden_size + cond_size
        self.num_heads = num_heads
        self.q_proj = nn.Linear(qk_size, qk_size, bias=False)
        self.k_proj = nn.Linear(qk_size, qk_size, bias=False)
        self.v_proj = nn.Linear(hidden_size, hidden_size, bias=False)
        self.o_proj = nn.Linear(hidden_size, hidden_size, bias=False)

    def forward(self, x, cond, segment_ids, cos, sin):
        b, n, hidden = x.shape
        qk_in = x if cond is None else torch.cat([x, cond], dim=-1)
        q = apply_rotary(self.q_proj(qk_in).reshape(b, n, self.num_heads, -1), cos, sin)
        k = apply_rotary(self.k_proj(qk_in).reshape(b, n, self.num_heads, -1), cos, sin)
        v = self.v_proj(x).reshape(b, n, self.num_heads, -1)
        # the qk head dim exceeds the v head dim; the kernel takes both as is
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              segment_ids, segment_ids)
        return self.o_proj(out.transpose(1, 2).reshape(b, n, hidden))


class AttnFuserLayer(nn.Module):
    def __init__(self, hidden_size: int, cond_size: int, num_heads: int,
                 hidden_act: str = "silu"):
        super().__init__()
        self.norm1 = RMSNorm(hidden_size, 1e-6)
        self.attn = CondSdpaAttention(hidden_size, cond_size, num_heads)
        self.norm2 = RMSNorm(hidden_size, 1e-6)
        self.mlp = GatedMLP(hidden_size, hidden_size * 2, hidden_act, bias=True)

    def forward(self, x, cond, segment_ids, cos, sin):
        h = x + self.attn(self.norm1(x), cond, segment_ids, cos, sin)
        return h + self.mlp(self.norm2(h))


class AttnFuserDummy(nn.Module):
    """Training-free predictor: normalized mean attention as logits."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.gp = cfg.gp

    def forward(self, attn_map, taps, window_index, reverse_index, segment_ids, pos_ids,
                valid, group_ids=None):
        return _normalized_mean_attention(attn_map, valid, self.gp.use_attention_logits,
                                          group_ids)[None]


class AttnFuserV1(nn.Module):
    """Conditioned fuser: one AttnFuserLayer per selected ViT tap layer.

    attn_map [B, N, n_sel_layers * n_heads] and taps (list of
    [B, N, vit_hidden]) in natural order -> logits [n_out, B, N] in natural
    order; the last row decides, the one before it (at inference) is the
    normalized raw attention."""

    with_condition = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        gp = cfg.gp
        self.gp = gp
        n_layers = len(gp.selected_visual_layers)
        cond_size = gp.visual_cond_size if (self.with_condition and n_layers > 0) else 0
        n_in = len(gp.selected_layers) * cfg.text.num_attention_heads
        self.qk_head_dim = (gp.attn_fuse_size + cond_size) // gp.attn_fuse_num_heads
        self.attn_in_proj = nn.Linear(n_in, gp.attn_fuse_size)
        if self.with_condition:
            self.cond_in_projs = nn.ModuleList(
                nn.Linear(cfg.vision.hidden_size, cond_size) for _ in range(n_layers))
        self.layers = nn.ModuleList(
            AttnFuserLayer(gp.attn_fuse_size, cond_size, gp.attn_fuse_num_heads,
                           gp.attn_fuse_hidden_act) for _ in range(n_layers))
        # the output heads that exist in the JAX checkpoint: every layer's
        # under deep supervision, else the last one's
        self.attn_out_projs = nn.ModuleDict({
            str(i): nn.Linear(gp.attn_fuse_size, 1) for i in range(n_layers)
            if gp.deep_supervision or i == n_layers - 1})

    def forward(self, attn_map, taps: Sequence[torch.Tensor], window_index, reverse_index,
                segment_ids, pos_ids, valid, group_ids=None):
        gp = self.gp
        outs: List[torch.Tensor] = []
        if gp.ori_attn_supervision:
            outs.append(_normalized_mean_attention(attn_map, valid, gp.use_attention_logits,
                                                   group_ids))
        dtype = self.attn_in_proj.weight.dtype
        x = _permute(self.attn_in_proj(attn_map.to(dtype)), window_index)
        b, n, _ = x.shape
        cos, sin = vision_rope_cos_sin(pos_ids.reshape(-1, 2), self.qk_head_dim)
        cos = cos.reshape(b, n, -1).to(dtype)
        sin = sin.reshape(b, n, -1).to(dtype)
        for i, layer in enumerate(self.layers):
            cond = None
            if self.with_condition:
                cond = self.cond_in_projs[i](_permute(taps[i].to(dtype), window_index))
            x = layer(x, cond, segment_ids, cos, sin)
        if len(self.layers):
            logit = self.attn_out_projs[str(len(self.layers) - 1)](x)[..., 0]
            outs.append(_permute(logit, reverse_index).float())
        return torch.stack(outs)


class AttnFuserV2(AttnFuserV1):
    """V1 without visual conditioning."""

    with_condition = False


ATTN_FUSERS = {cls.__name__: cls for cls in (AttnFuserDummy, AttnFuserV1, AttnFuserV2)}


def make_fuser(cfg: ModelConfig) -> nn.Module:
    return ATTN_FUSERS[cfg.gp.attn_fuse_type](cfg)

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

``emit_importance`` (JAX :106-127, :246-254) adds the VisionZip / VScan
scores of the blocks at ``first_fullatt`` and ``depth - 1``: the attention
each key receives, meaned over heads and summed over queries, and the keys
meaned over heads, pooled per merge unit. Such a block ropes q and k
itself; a windowed one attends through K8 (``batched_window_attention``),
a full-attention one through K2 in bf16 even in an int8-attention tier.
The score softmax is dense over the whole packed sequence under the
full-attention segment mask, as in the JAX package, taken one head at a
time so that one [P, P] fp32 matrix is live at once.

Under sequence parallelism (parallel/sequence.py) the block stack runs on
this rank's shard of whole windows when P divides (``sp_split(P, wp)``,
read at each call): the patches, rope tables, segment ids and valid mask
are split, windowed blocks attend within the local windows with no
collective, full-attention blocks attend with local queries over the
gathered keys, and the taps (merge-unit means, which never straddle a
window) and the stack's output are gathered before the merger, which runs
replicated. ``emit_importance`` runs sharded too: an importance block's
queries are this rank's rows over the gathered keys, so the attention
each key receives is a sum over this rank's queries, all-reduced over the
SP group, and the keys' head means, per row, are pooled per merge unit and
gathered with the rows.

Under tensor parallelism (parallel/mesh.py ``shard_params``) each block's
qkv holds this rank's heads, per (3, heads / tp, D) of its [3, heads, D]
output, the attention runs on them, and proj and the MLP's down
all-reduce their partial sums (models/layers.py); the merger is whole.
``emit_importance``'s head means are sums over this rank's heads,
all-reduced over the model axis and divided by the whole head count.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from glimpseprune_torch.config import VisionConfig
from glimpseprune_torch.models.layers import GatedMLP, Linear, RMSNorm
from glimpseprune_torch.ops.attention import (
    NEG_INF,
    batched_window_attention,
    fused_window_attention,
    segment_attention,
)
from glimpseprune_torch.ops.rope import apply_rotary, vision_rope_cos_sin
from glimpseprune_torch.parallel.sequence import SeqShard, all_reduce_sum, gather_seq, sp_split


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

    def forward(self, x, cos, sin, segment_ids, valid, wp: int, dense_attn: bool = False,
                emit_importance: bool = False, sp: Optional[SeqShard] = None,
                tp: Optional[SeqShard] = None):
        """wp > 0 selects the window path; otherwise full attention over
        segment_ids (dense_attn: one unpadded image, no mask). With
        emit_importance returns (x, (received [P], keys_mean [P, D])).
        Under ``sp`` the inputs are this rank's shard of whole windows
        (received stays whole, keys_mean is this rank's rows); under ``tp``
        (the model axis, where the heads are sharded) qkv holds this rank's
        heads."""
        c = self.cfg
        p = x.shape[0]
        a8 = c.act_quant in ("int8", "prefill")
        # the local heads under tensor parallelism
        qkv = self.attn.qkv(self.norm1(x), a8).reshape(p, 3, -1, c.head_dim)
        if wp > 0 and not emit_importance:
            attn = fused_window_attention(qkv, cos, sin, valid, wp)
        else:
            q = apply_rotary(qkv[:, 0][None], cos[None], sin[None])[0]
            k = apply_rotary(qkv[:, 1][None], cos[None], sin[None])[0]
            if wp > 0:
                attn = batched_window_attention(q, k, qkv[:, 2], valid, wp)
            else:
                attn = segment_attention(q, k, qkv[:, 2], segment_ids, dense=dense_attn,
                                         int8_qk=a8 and c.attn_qk_int8 and not emit_importance,
                                         int8_pv=a8 and c.attn_pv_int8 and not emit_importance,
                                         sp=sp)
        x = x + self.attn.proj(attn.reshape(p, -1), a8)
        x = x + self.mlp(self.norm2(x), a8)
        if emit_importance:
            return x, importance_scores(q, k, segment_ids, c.num_heads, sp, tp)
        return x


def importance_scores(q: torch.Tensor, k: torch.Tensor, segment_ids: torch.Tensor,
                      heads: int, sp: Optional[SeqShard] = None,
                      tp: Optional[SeqShard] = None):
    """(received [P] over every key, keys' head mean [rows, D]) of an
    importance block from this rank's q and k rows and heads: under ``sp``
    the keys and their segments are gathered and each rank sums over its
    queries, then the sums are all-reduced over the SP group; under ``tp``
    each rank sums over its heads, all-reduced over the model axis, divided
    by the whole ``heads``."""
    if sp is None and tp is None:
        return received_attention(q, k, segment_ids), k.float().mean(1)
    k_all, seg_all = k, segment_ids
    if sp is not None:
        k_all, seg_all = gather_seq(k, 0, sp), gather_seq(segment_ids, 0, sp)
    received = received_attention(q, k_all, segment_ids, seg_all,
                                  0 if sp is None else sp.rank * q.shape[0], heads)
    keys = k.float().mean(1)
    if sp is not None:
        received = all_reduce_sum(received, sp.group)
    if tp is not None:
        received = all_reduce_sum(received, tp.group)
        keys = all_reduce_sum(k.float().sum(1), tp.group) / heads
    return received, keys


def received_attention(q: torch.Tensor, k: torch.Tensor, segment_ids: torch.Tensor,
                       kv_segment_ids: Optional[torch.Tensor] = None, q_offset: int = 0,
                       heads: Optional[int] = None) -> torch.Tensor:
    """Attention each key receives (JAX vision.py:117-127): the softmax of
    q k^T / sqrt(D) over the keys of the query's segment (a pad query
    attends to itself), meaned over heads and summed over queries -> [P]
    fp32. q [Pq, H, D] / k [P, H, D] with rope applied; one head at a time.
    A shard's part: its queries are rows [q_offset, q_offset + Pq) of the
    keys' sequence (``kv_segment_ids``, default ``segment_ids``), and the
    sum over its H heads is divided by ``heads`` (default H), the whole
    head count where the heads are sharded."""
    pq, h, d = q.shape
    p = k.shape[0]
    kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
    keys = torch.arange(p, device=q.device)
    eye = keys[None, :] == (q_offset + torch.arange(pq, device=q.device))[:, None]
    allowed = ((segment_ids[:, None] == kv_seg[None, :]) & (segment_ids >= 0)[:, None]) | eye
    received = torch.zeros((p,), dtype=torch.float32, device=q.device)
    for head in range(h):
        logits = (q[:, head].float() @ k[:, head].float().T) * (1.0 / d ** 0.5)
        probs = torch.softmax(logits.masked_fill(~allowed, NEG_INF), dim=-1)
        received += probs.sum(0)
    return received / (h if heads is None else heads)


class VisionTransformer(nn.Module):
    """Inputs in the window-padded slot layout: patches [P, in_dim],
    pos_ids [P, 2], full_seg [P] (-1 = pad), valid [P]. Returns
    (merged [P // mu, out_hidden], taps [P // mu, hidden] per tap layer)."""

    attn_tp: Optional[SeqShard] = None  # the model axis where the heads are sharded

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

    def forward(self, patches, pos_ids, full_seg, valid, dense_attn: bool = False,
                emit_importance: bool = False):
        """-> (merged, taps), or with emit_importance (merged, taps,
        (received, keys_mean, received_local)): the last block's received
        attention and head-mean keys and the first full-attention block's
        received attention, each pooled per merge unit (the last block's
        scores stand in for the local ones when both are the same block)."""
        c = self.cfg
        mu = c.spatial_merge_unit
        dtype = self.patch_embed.weight.dtype
        sp = sp_split(patches.shape[0], self.window_patches)
        if sp is not None:
            rows = sp.slice(patches.shape[0])
            patches, pos_ids, full_seg, valid = (patches[rows], pos_ids[rows], full_seg[rows],
                                                 valid[rows])
        x = self.patch_embed(patches.to(dtype))
        cos, sin = vision_rope_cos_sin(pos_ids, c.head_dim)
        cos, sin = cos.to(dtype), sin.to(dtype)
        fullatt = set(c.fullatt_block_indexes)
        first_fullatt = min(fullatt) if fullatt else 0
        taps: List[torch.Tensor] = [None] * len(self.tap_layers)
        importance = received_local = None
        for i, block in enumerate(self.blocks):
            want_imp = emit_importance and i in (first_fullatt, c.depth - 1)
            out = block(x, cos, sin, full_seg, valid, 0 if i in fullatt else self.window_patches,
                        dense_attn=dense_attn, emit_importance=want_imp, sp=sp,
                        tp=self.attn_tp)
            if want_imp:
                x, (received, keys_mean) = out
                pooled = received.reshape(-1, mu).mean(1)
                if i == first_fullatt:
                    received_local = pooled
                if i == c.depth - 1:
                    keys = keys_mean.reshape(-1, mu, keys_mean.shape[-1]).mean(1)
                    importance = (pooled, keys if sp is None else gather_seq(keys, 0, sp),
                                  pooled if received_local is None else received_local)
            else:
                x = out
            if i in self.tap_layers:
                tap = x.reshape(-1, mu, c.hidden_size).mean(1)
                taps[self.tap_layers.index(i)] = tap if sp is None else gather_seq(tap, 0, sp)
        if sp is not None:
            x = gather_seq(x, 0, sp)
        merged = self.merger_ln_q(x).reshape(-1, mu * c.hidden_size)
        merged = self.merger_fc2(F.gelu(self.merger_fc1(merged)))
        if emit_importance:
            return merged, taps, importance
        return merged, taps

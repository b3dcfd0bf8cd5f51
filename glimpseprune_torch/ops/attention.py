"""Attention entry points of the model: ViT segment and window attention,
the LLM's causal prefill, and decode over a KV cache.

Counterparts of glimpseprune_tpu/ops/attention.py. Prefill attention goes
through the CUDA kernels (ops/cuda/): K2 for segment and causal attention,
K1 for the fused rope + window attention, K8 for window attention on
already-roped q, k, v; each takes its plain PyTorch version on CPU tensors.
Segment and causal attention follow K2's semantics on every device: a
query row with no allowed key outputs 0, where the JAX package's
XLA paths let such padding rows attend to themselves. Padding rows never
reach a valid output, so the two agree on every valid row.
The int8 serving tier (``int8_qk``, ``int8_pv``) goes through K7, the
int8 flavour of the flash kernel. Decode attention has no kernel in the JAX
package either; it is plain PyTorch here, over a cache in the model dtype
or in the int8 tier of ops/kv_cache.py.

Under sequence parallelism (parallel/sequence.py; JAX :42-190) the caller
passes ``sp``, the shard the layer stack runs on, and these entry points
take and return this rank's shard: segment and causal attention keep q
local and gather k, v and the segment ids or padding mask once
(``gather_kv``), causal attention masks against global slots through K9
(the flash kernel's q_positions flavour), and window attention runs on the
rank's whole windows with no collective.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from glimpseprune_torch.ops.cuda.flash_attention import flash_attention
from glimpseprune_torch.ops.cuda.window_attention import (
    window_attention,
    window_attention_fused,
)
from glimpseprune_torch.ops.kv_cache import Cache, is_quantized
from glimpseprune_torch.parallel.sequence import SeqShard, gather_kv, gather_seq

NEG_INF = -1e30


def _gather_kv_pair(k: torch.Tensor, v: torch.Tensor, dim: int, sp: SeqShard):
    """k and v of every rank, in one collective (they share a shape)."""
    kv = gather_kv(torch.stack([k, v]), dim + 1, sp)
    return kv[0], kv[1]


def segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      segment_ids: torch.Tensor, dense: bool = False,
                      int8_qk: bool = False, int8_pv: bool = False,
                      sp: Optional[SeqShard] = None) -> torch.Tensor:
    """Bidirectional block-diagonal attention over the packed ViT sequence.

    q/k/v [S, H, D]; segment_ids [S] (attend iff equal; < 0 is padding).
    dense=True promises one valid segment (a single unpadded image), so no
    mask is applied. int8_qk runs QK^T in int8 (per-row q/k), int8_pv also
    the PV product (the JAX package's :216-256). Returns [S, H, D]. Under
    ``sp`` every input is this rank's shard: k, v and the segment ids are
    gathered, and the local queries attend over the whole sequence."""
    q_seg = kv_seg = None if dense else segment_ids[None]
    if sp is not None:
        k, v = _gather_kv_pair(k, v, 0, sp)
        if not dense:
            kv_seg = gather_seq(segment_ids, 0, sp)[None]
    out = flash_attention(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                          v.transpose(0, 1)[None], q_seg, kv_seg, dense=dense,
                          qkv_int8=int8_qk, pv_int8=int8_qk and int8_pv)
    return out[0].transpose(0, 1)


def batched_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             valid: torch.Tensor, wp: int) -> torch.Tensor:
    """Attention within fixed windows of wp patches (the JAX :268-317):
    q/k/v [P, H, D] with rope applied, valid [P] -> [P, H, D]. Pad slots
    attend to themselves, so every row is defined. Under sequence
    parallelism the caller passes its shard of whole windows: no
    collective."""
    return window_attention(q.contiguous(), k.contiguous(), v.contiguous(), valid, wp)


def fused_window_attention(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                           valid: torch.Tensor, wp: int) -> torch.Tensor:
    """Rope + attention inside each window of wp patches: qkv [P, 3, H, D]
    pre-rope, cos/sin [P, D], valid [P] -> [P, H, D]. Under sequence
    parallelism the caller passes its shard of whole windows (and their rope
    rows): no collective."""
    return window_attention_fused(qkv, cos, sin, valid, wp)


def causal_segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             valid: torch.Tensor, int8_qk: bool = False,
                             int8_pv: bool = False, sp: Optional[SeqShard] = None):
    """Causal GQA self-attention over a left-padded batch.

    q [B, S, Hq, D], k/v [B, S, Hkv, D], valid [B, S] -> (out [B, S, Hq, D],
    k, v), where k and v are the ones attended over: what the KV cache
    keeps. int8_qk / int8_pv: as in segment_attention. Under ``sp`` every
    input and ``out`` are this rank's shard of the sequence: k, v and valid
    are gathered (the returned k and v are the whole sequence's), and K9
    masks each local query against its global slot."""
    seg_q = seg_k = torch.where(valid, 0, -1).to(torch.int32)
    q_positions = None
    if sp is not None:
        k, v = _gather_kv_pair(k, v, 1, sp)
        seg_k = gather_seq(seg_q, 1, sp)
        b, sl = valid.shape
        q_positions = (sp.rank * sl + torch.arange(sl, device=q.device, dtype=torch.int32)
                       ).expand(b, sl).contiguous()  # as the kernel reads it
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          seg_q, seg_k, causal=True, qkv_int8=int8_qk,
                          pv_int8=int8_qk and int8_pv, q_positions=q_positions)
    return out.transpose(1, 2), k, v


def decode_attention(q: torch.Tensor, k_cache: Cache, v_cache: Cache,
                     kv_valid: torch.Tensor, k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None,
                     write_idx: Union[int, torch.Tensor, None] = None,
                     new_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """New queries over a cached prefix (JAX :406-490), in two modes.

    q [B, S_new, Hq, D]; caches [B, T, Hkv, D]; kv_valid [B, T].
    - k_new/v_new [B, S_new, Hkv, D] given (decode and chunked prefill):
      cache slots >= write_idx are stale and masked, and the new tokens
      attend causally among themselves from k_new/v_new. The cache is read
      before the layer writes the new tokens into it
      (language._layer_decode), as in the JAX package. new_valid [B, S_new]
      masks new keys (a left-padded row's pads inside a prefill chunk).
    - legacy (k_new None): the queries attend over the valid cache slots;
      with S_new > 1 the last S_new slots are the new tokens, causal among
      themselves. write_idx and new_valid are not read.
    Grouped GQA: the cache is never expanded to Hq heads. write_idx is an
    int or a 0-d tensor on q's device; nothing here reads a device value on
    the host, so a captured decode step masks by the slot of each replay.

    An int8 cache ({"q": int8 [B, T, Hkv, D], "s": f32 [B, T, Hkv]}) is
    read as its integer values: the key scale multiplies the logits and the
    value scale is folded into the probabilities (JAX :433-489), so the
    cache is never dequantized. Returns [B, S_new, Hq, D]."""
    b, s_new, hq, d = q.shape
    quant = is_quantized(k_cache)
    k_vals = k_cache["q"] if quant else k_cache
    v_vals = v_cache["q"] if quant else v_cache
    t, hkv = k_vals.shape[1], k_vals.shape[2]
    g = hq // hkv
    scale = 1.0 / d ** 0.5
    qg = q.reshape(b, s_new, hkv, g, d).float()
    slots = torch.arange(t, device=q.device)
    if k_new is None:  # slot t - s_new + i is query i's own
        allowed = kv_valid[:, None, None, None, :] & (
            slots <= t - s_new + torch.arange(s_new, device=q.device)[:, None])
    else:
        allowed = kv_valid[:, None, None, None, :] & (slots < write_idx)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k_vals.float()) * scale
    if quant:
        logits = logits * k_cache["s"].transpose(1, 2)[:, :, None, None, :]
    logits = logits.masked_fill(~allowed, NEG_INF)
    if k_new is not None:
        logits_n = torch.einsum("bskgd,bukd->bkgsu", qg, k_new.float()) * scale
        allowed_n = torch.ones((s_new, s_new), dtype=torch.bool, device=q.device).tril()
        if new_valid is not None:
            allowed_n = allowed_n & new_valid[:, None, None, None, :]
        logits = torch.cat([logits, logits_n.masked_fill(~allowed_n, NEG_INF)], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    pc = probs[..., :t]
    if quant:
        pc = pc * v_cache["s"].transpose(1, 2)[:, :, None, None, :]
    out = torch.einsum("bkgst,btkd->bskgd", pc, v_vals.float())
    if k_new is not None:
        out = out + torch.einsum("bkgsu,bukd->bskgd", probs[..., t:], v_new.float())
    return out.reshape(b, s_new, hq, d).to(q.dtype)

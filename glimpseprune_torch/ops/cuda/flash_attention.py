"""K2: flash attention forward with segment ids, causal masking and GQA.

Replaces the forward of the Pallas kernel ``flash_attention``
(glimpseprune_tpu/ops/pallas/flash_attention.py:400 -> ``_flash_attention_impl``
:490, bodies ``_kernel`` :32 and ``_dense_kernel_adapter`` :639). The CUDA
source is ``glimpseprune_torch/csrc/flash_attention.cu``; its header says
what bounds it on the H100 and how the design answers.

The TPU tuning does not carry over: there are no 1024x1024 blocks and no
head-dim padding to 128. The qk head dim and the v head dim are separate
arguments, so the fuser's 192/64 call reads v as it is.

Dispatch is by device: a CPU tensor takes the plain PyTorch version below,
a CUDA tensor launches the kernel (or raises).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from glimpseprune_torch.ops.cuda.build import check_launch, load_library

NEG_INF = -1e30
MAX_DQK = 256
MAX_DV = 128
FLAVOURS = ("causal", "dense", "dqk_ne_dv", "segmented")


def flavour(causal: bool, dense: bool, dqk: int, dv: int) -> str:
    """The launch-count bucket of one call: the first that applies of
    causal, dense, dqk != dv, segmented."""
    if causal:
        return "causal"
    if dense:
        return "dense"
    return "dqk_ne_dv" if dqk != dv else "segmented"


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              q_segment_ids: Optional[torch.Tensor],
                              kv_segment_ids: Optional[torch.Tensor],
                              causal: bool = False, dense: bool = False) -> torch.Tensor:
    """Plain version: fp32 math from the given inputs, output in q's dtype.

    q [B, Hq, Sq, Dqk], k [B, Hkv, Skv, Dqk], v [B, Hkv, Skv, Dv]; segment
    ids [B, S] int (ignored when dense). A row with no allowed key is 0."""
    b, hq, sq, dqk = q.shape
    g = hq // k.shape[1]
    skv = k.shape[2]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scores = q.float() @ kf.transpose(-1, -2) * (1.0 / dqk ** 0.5)
    if dense:
        allowed = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
    else:
        qs = q_segment_ids[:, :, None]
        allowed = (qs == kv_segment_ids[:, None, :]) & (qs >= 0)
    if causal:
        pos_q = torch.arange(sq, device=q.device)[:, None]
        allowed = allowed & (pos_q >= torch.arange(skv, device=q.device)[None, :])
    scores = scores.masked_fill(~allowed[:, None], NEG_INF)
    out = torch.softmax(scores, dim=-1) @ vf
    out = out.masked_fill(~allowed.any(-1)[:, None, :, None], 0.0)
    return out.to(q.dtype)


def _strides(t: torch.Tensor, name: str):
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous last dim")
    st = t.stride()[:3]
    if max(st) >= 2 ** 31:
        raise ValueError(f"flash_attention: {name} strides exceed int32")
    return st


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    causal: bool = False, dense: bool = False) -> torch.Tensor:
    """Attention of q [B, Hq, Sq, Dqk] over k [B, Hkv, Skv, Dqk] and
    v [B, Hkv, Skv, Dv] -> [B, Hq, Sq, Dv].

    q, k and v may be strided views (the last dim must be contiguous). On
    the card the output is a [B, Hq, Sq, Dv] view of a [B, Sq, Hq, Dv]
    buffer, so ``out.transpose(1, 2)`` is contiguous.
    ``flash_attention.launches[flavour]`` counts kernel launches."""
    if not dense and (q_segment_ids is None or kv_segment_ids is None):
        raise ValueError("flash_attention: segment ids are required unless dense")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, q_segment_ids, kv_segment_ids,
                                         causal, dense)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, hq, sq, dqk = q.shape
    _, hkv, skv, dv = v.shape
    if k.shape != (b, hkv, skv, dqk) or v.shape[0] != b or hq % hkv:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} do not match")
    if causal and sq != skv:
        raise ValueError("flash_attention: causal needs Sq == Skv")
    if not (0 < dqk <= MAX_DQK and 0 < dv <= MAX_DV):
        raise ValueError(f"flash_attention: unsupported head dims {dqk}/{dv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be bf16 on {q.device}")
    strides = _strides(q, "q") + _strides(k, "k") + _strides(v, "v")
    seg_ptrs = (None, None)
    if not dense:
        q_segment_ids = q_segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        kv_segment_ids = kv_segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        if q_segment_ids.shape != (b, sq) or kv_segment_ids.shape != (b, skv):
            raise ValueError("flash_attention: segment ids must be [B, Sq] and [B, Skv]")
        seg_ptrs = (q_segment_ids.data_ptr(), kv_segment_ids.data_ptr())
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    fn = load_library("flash_attention").flash_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 20 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *seg_ptrs,
            b, hq, hkv, sq, skv, dqk, dv, *strides, *out.stride()[:3],
            int(causal), stream)
    check_launch(rc, "flash_attention")
    flash_attention.launches[flavour(causal, dense, dqk, dv)] += 1
    return out


flash_attention.launches = dict.fromkeys(FLAVOURS, 0)

"""K2, K2-lse and K3: flash attention forward, forward with LSE, backward.

Replaces the Pallas kernels of glimpseprune_tpu/ops/pallas/flash_attention.py:
- K2, the forward ``flash_attention`` :400 -> ``_flash_attention_impl`` :490
  (bodies ``_kernel`` :32 and ``_dense_kernel_adapter`` :639), with segment
  ids, causal masking and GQA;
- K2-lse, its training flavour (``_lse_kernel_adapter`` :208,
  ``_dense_lse_kernel_adapter`` :224), which also writes the per-row
  log-sum-exp [B, Hq, Sq] f32 in the log2 domain, as the Pallas kernel does;
- K3, the backward ``_flash_bwd_impl`` :808 (``_bwd_dq_kernel`` :697,
  ``_bwd_dkv_kernel`` :739), which recomputes the probabilities from that LSE.
The CUDA sources are ``glimpseprune_torch/csrc/flash_attention.cu`` (K2 and
K2-lse, one kernel with an optional LSE output) and ``flash_attention_bwd.cu``
(K3); their headers say what bounds them on the H100 and how the design
answers.

The TPU tuning does not carry over: there are no 1024x1024 blocks and no
head-dim padding to 128. The qk head dim and the v head dim are separate
arguments, so the fuser's 192/64 call reads v as it is.

Dispatch is by device: a CPU tensor takes the plain PyTorch version beside
each kernel, a CUDA tensor launches the kernel (or raises). ``flash_attention``
is differentiable: when autograd records, it goes through
``FlashAttentionFunction`` (K2-lse forward, K3 backward; on the CPU their plain
versions), otherwise it launches the plain forward K2.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from glimpseprune_torch.ops.cuda.build import check_launch, load_library

NEG_INF = -1e30
LOG2E = math.log2(math.e)
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


def allowed_mask(q_segment_ids: Optional[torch.Tensor], kv_segment_ids: Optional[torch.Tensor],
                 b: int, sq: int, skv: int, causal: bool, dense: bool,
                 device) -> torch.Tensor:
    """[B, Sq, Skv] bool: key t is allowed for query s iff the segment ids
    are equal and the query's is >= 0 (all keys when dense), and t <= s when
    causal."""
    if dense:
        allowed = torch.ones((b, sq, skv), dtype=torch.bool, device=device)
    else:
        qs = q_segment_ids[:, :, None]
        allowed = (qs == kv_segment_ids[:, None, :]) & (qs >= 0)
    if causal:
        pos_q = torch.arange(sq, device=device)[:, None]
        allowed = allowed & (pos_q >= torch.arange(skv, device=device)[None, :])
    return allowed


def _scores(q, k, v):
    """fp32 scaled scores [B, Hq, Sq, Skv] and the GQA-expanded k, v."""
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    return q.float() @ kf.transpose(-1, -2) * (1.0 / q.shape[-1] ** 0.5), kf, vf


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  q_segment_ids: Optional[torch.Tensor],
                                  kv_segment_ids: Optional[torch.Tensor],
                                  causal: bool = False,
                                  dense: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 and K2-lse: fp32 math from the given inputs.

    q [B, Hq, Sq, Dqk], k [B, Hkv, Skv, Dqk], v [B, Hkv, Skv, Dv]; segment
    ids [B, S] int (ignored when dense). Returns (out [B, Hq, Sq, Dv] in q's
    dtype, lse [B, Hq, Sq] f32): lse is log2(sum_t 2^(s_t log2 e)), the
    log-sum-exp of the scaled scores in the log2 domain, and -1e30 for a row
    with no allowed key, whose output is 0."""
    b, _, sq, _ = q.shape
    scores, _, vf = _scores(q, k, v)
    allowed = allowed_mask(q_segment_ids, kv_segment_ids, b, sq, k.shape[2], causal, dense,
                           q.device)
    scores = scores.masked_fill(~allowed[:, None], NEG_INF)
    seen = allowed.any(-1)[:, None, :]  # [B, 1, Sq]
    lse = torch.logsumexp(scores, dim=-1)  # the softmax's own normalizer
    out = torch.exp(scores - lse[..., None]) @ vf
    out = out.masked_fill(~seen[..., None], 0.0)
    lse = torch.where(seen, lse * LOG2E, torch.full((), NEG_INF, device=q.device))
    return out.to(q.dtype), lse


def flash_attention_reference(q, k, v, q_segment_ids, kv_segment_ids,
                              causal: bool = False, dense: bool = False) -> torch.Tensor:
    """Plain version of K2: the output of ``flash_attention_lse_reference``."""
    return flash_attention_lse_reference(q, k, v, q_segment_ids, kv_segment_ids,
                                         causal, dense)[0]


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_segment_ids: Optional[torch.Tensor], kv_segment_ids: Optional[torch.Tensor],
        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
        causal: bool = False, dense: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3, in fp32 from the given inputs: the probabilities
    recomputed from q, k and the log2-domain lse (0 on rows whose lse is
    -1e30), dsum = rowsum(dO * O), ds = p * (dO V^T - dsum), then
    dq = ds K / sqrt(Dqk), dk = ds^T Q / sqrt(Dqk), dv = p^T dO, with dk and
    dv summed over each GQA group. Returns (dq, dk, dv) in q, k, v's dtypes."""
    b, hq, sq, dqk = q.shape
    hkv, skv, dv_dim = v.shape[1], v.shape[2], v.shape[3]
    g = hq // hkv
    scale = 1.0 / dqk ** 0.5
    scores, kf, vf = _scores(q, k, v)
    allowed = allowed_mask(q_segment_ids, kv_segment_ids, b, sq, skv, causal, dense,
                           q.device)[:, None] & (lse > NEG_INF / 2)[..., None]
    s2 = (scores * LOG2E).masked_fill(~allowed, NEG_INF)
    p = torch.exp2(s2 - lse[..., None]).masked_fill(~allowed, 0.0)
    dof = dout.float()
    dsum = (dof * out.float()).sum(-1)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - dsum[..., None])
    dq = ds @ kf * scale
    dk = (ds.transpose(-1, -2) @ q.float() * scale).reshape(b, hkv, g, skv, dqk).sum(2)
    dv = (p.transpose(-1, -2) @ dof).reshape(b, hkv, g, skv, dv_dim).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides(t: torch.Tensor, name: str):
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous last dim")
    st = t.stride()[:3]
    if max(st) >= 2 ** 31:
        raise ValueError(f"flash_attention: {name} strides exceed int32")
    return st


def _check(q, k, v, q_segment_ids, kv_segment_ids, causal, dense):
    """Validate a CUDA call -> (segment-id pointers, int32 segment ids)."""
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
    if dense:
        return (None, None), (None, None)
    qseg = q_segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    kseg = kv_segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    if qseg.shape != (b, sq) or kseg.shape != (b, skv):
        raise ValueError("flash_attention: segment ids must be [B, Sq] and [B, Skv]")
    return (qseg.data_ptr(), kseg.data_ptr()), (qseg, kseg)


def _device_of(q: torch.Tensor, dense: bool, q_segment_ids, kv_segment_ids) -> str:
    if not dense and (q_segment_ids is None or kv_segment_ids is None):
        raise ValueError("flash_attention: segment ids are required unless dense")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return q.device.type


def _launch_forward(q, k, v, q_segment_ids, kv_segment_ids, causal, dense, with_lse):
    """One launch of csrc/flash_attention.cu -> (out, lse or None)."""
    b, hq, sq, dqk = q.shape
    _, hkv, skv, dv = v.shape
    seg_ptrs, _keep = _check(q, k, v, q_segment_ids, kv_segment_ids, causal, dense)
    strides = _strides(q, "q") + _strides(k, "k") + _strides(v, "v")
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    fn = load_library("flash_attention").flash_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 20 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), *seg_ptrs,
            b, hq, hkv, sq, skv, dqk, dv, *strides, *out.stride()[:3],
            int(causal), stream)
    check_launch(rc, "flash_attention")
    return out, lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        dense: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-lse: ``flash_attention``'s output and the per-row log2-domain LSE
    [B, Hq, Sq] f32 (-1e30 on rows with no allowed key), which K3 reads.
    ``flash_attention_lse.launches[flavour]`` counts kernel launches."""
    if _device_of(q, dense, q_segment_ids, kv_segment_ids) == "cpu":
        return flash_attention_lse_reference(q, k, v, q_segment_ids, kv_segment_ids,
                                             causal, dense)
    out, lse = _launch_forward(q, k, v, q_segment_ids, kv_segment_ids, causal, dense, True)
    if out.numel():
        flash_attention_lse.launches[flavour(causal, dense, q.shape[-1], v.shape[-1])] += 1
    return out, lse


def flash_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_segment_ids: Optional[torch.Tensor], kv_segment_ids: Optional[torch.Tensor],
        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
        causal: bool = False, dense: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: (dq, dk, dv) of attention from the forward's output and LSE.

    On the card dsum = rowsum(dO * O) is one PyTorch reduction (the JAX
    package computes it outside Pallas too, :818), then one launch of
    csrc/flash_attention_bwd.cu writes dq, dk, dv as [B, H, S, D] views of
    [B, S, H, D] buffers. ``flash_attention_backward.launches[flavour]``
    counts kernel launches."""
    if _device_of(q, dense, q_segment_ids, kv_segment_ids) == "cpu":
        return flash_attention_backward_reference(q, k, v, q_segment_ids, kv_segment_ids,
                                                  out, lse, dout, causal, dense)
    b, hq, sq, dqk = q.shape
    _, hkv, skv, dv = v.shape
    seg_ptrs, _keep = _check(q, k, v, q_segment_ids, kv_segment_ids, causal, dense)
    if out.shape != (b, hq, sq, dv) or dout.shape != out.shape or lse.shape != (b, hq, sq):
        raise ValueError("flash_attention_backward: out, dout or lse has the wrong shape")
    dout = dout.to(torch.bfloat16)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    lse = lse.to(torch.float32).contiguous()
    dsum = (dout.float() * out.float()).sum(-1).contiguous()
    dq = torch.empty((b, sq, hq, dqk), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((b, skv, hkv, dqk), dtype=k.dtype, device=q.device).transpose(1, 2)
    dvv = torch.empty((b, skv, hkv, dv), dtype=v.dtype, device=q.device).transpose(1, 2)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dvv.zero_()
    strides = (_strides(q, "q") + _strides(k, "k") + _strides(v, "v")
               + _strides(dout, "dout") + dq.stride()[:3] + dk.stride()[:3]
               + dvv.stride()[:3])
    fn = load_library("flash_attention_bwd").flash_attention_bwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 29 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dsum.data_ptr(), *seg_ptrs, dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
            b, hq, hkv, sq, skv, dqk, dv, *strides, int(causal), stream)
    check_launch(rc, "flash_attention_backward")
    flash_attention_backward.launches[flavour(causal, dense, dqk, dv)] += 1
    return dq, dk, dvv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention: K2-lse forward, K3 backward (their
    plain versions on CPU tensors). Segment ids and flags get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, causal: bool, dense: bool):
        out, lse = flash_attention_lse(q, k, v, q_segment_ids, kv_segment_ids, causal, dense)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, out, lse)
        ctx.flags = (causal, dense)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qseg, kseg, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, qseg, kseg, out, lse, dout, *ctx.flags)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    causal: bool = False, dense: bool = False) -> torch.Tensor:
    """Attention of q [B, Hq, Sq, Dqk] over k [B, Hkv, Skv, Dqk] and
    v [B, Hkv, Skv, Dv] -> [B, Hq, Sq, Dv].

    q, k and v may be strided views (the last dim must be contiguous). On
    the card the output is a [B, Hq, Sq, Dv] view of a [B, Sq, Hq, Dv]
    buffer, so ``out.transpose(1, 2)`` is contiguous. When autograd records
    a graph through q, k or v, the call goes through
    ``FlashAttentionFunction`` (K2-lse, then K3 in the backward); otherwise
    it is one K2 launch, counted in ``flash_attention.launches[flavour]``."""
    device = _device_of(q, dense, q_segment_ids, kv_segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, q_segment_ids, kv_segment_ids,
                                            causal, dense)
    if device == "cpu":
        return flash_attention_reference(q, k, v, q_segment_ids, kv_segment_ids, causal, dense)
    out, _ = _launch_forward(q, k, v, q_segment_ids, kv_segment_ids, causal, dense, False)
    if out.numel():
        flash_attention.launches[flavour(causal, dense, q.shape[-1], v.shape[-1])] += 1
    return out


flash_attention.launches = dict.fromkeys(FLAVOURS, 0)
flash_attention_lse.launches = dict.fromkeys(FLAVOURS, 0)
flash_attention_backward.launches = dict.fromkeys(FLAVOURS, 0)

"""K2, K2-lse and K3: flash attention forward, forward with LSE, backward.

Replaces the Pallas kernels of glimpseprune_tpu/ops/pallas/flash_attention.py:
- K2, the forward ``flash_attention`` :400 -> ``_flash_attention_impl`` :490
  (bodies ``_kernel`` :32 and ``_dense_kernel_adapter`` :639), with segment
  ids, causal masking and GQA;
- K2-lse, its training flavour (``_lse_kernel_adapter`` :208,
  ``_dense_lse_kernel_adapter`` :224), which also writes the per-row
  log-sum-exp [B, Hq, Sq] f32 in the log2 domain, as the Pallas kernel does;
- K3, the backward ``_flash_bwd_impl`` :808 (``_bwd_dq_kernel`` :697,
  ``_bwd_dkv_kernel`` :739), which recomputes the probabilities from that LSE;
- K7, the int8 serving flavour (``_i8_kernel_adapter`` :175,
  ``_i8_dense_kernel_adapter`` :200, with ``_quant_rows_i8`` :232 done here
  in plain PyTorch as JAX does it outside its kernel): per-row int8 q and k,
  an int32 QK^T with a rank-1 rescale, and with ``pv_int8`` an int8 PV
  product per kv tile. Inference only, as in JAX.
- K9, the ``q_positions`` flavour of K2, K2-lse, K3 and K7
  (``_qpos_kernel_adapter`` :183, ``_i8_qpos_kernel_adapter`` :191,
  ``_qpos_lse_kernel_adapter`` :216, the custom VJP
  ``_flash_attention_qpos_diff`` :341 with ``_bwd_dq_qpos_adapter`` :787 and
  ``_bwd_dkv_qpos_adapter`` :795): q [B, Hq, Sq, D] is a shard of a longer
  sequence whose k and v [B, Hkv, Skv, D] are given whole, and causal
  allows key t for query s iff t <= q_positions[b, s], the row's global
  slot. Sequence-parallel prefill calls it; its launches are counted under
  the flavour ``"causal+qpos"``.
The CUDA sources are ``glimpseprune_torch/csrc/flash_attention.cu`` (K2,
K2-lse and K9 on tensor cores; K7 and K9-int8 on their own scalar kernel)
and ``flash_attention_bwd.cu`` (K3 and K9's backward on tensor cores);
their headers say what bounds them on the H100 and how the design answers.
``plan_flash`` and ``plan_flash_bwd`` are the host-side plans: the padded
head-dim pair a kernel is built for, its tiles and its shared-memory
bytes, which the C launchers check.

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

import array
import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from glimpseprune_torch.ops.cuda.build import (
    SMEM_LIMIT,
    check_launch,
    current_stream,
    kernel_function,
)
from glimpseprune_torch.ops.kv_cache import quantize_kv

NEG_INF = -1e30
LOG2E = math.log2(math.e)
MAX_DQK = 256
MAX_DV = 128
FLAVOURS = ("causal", "causal+qpos", "dense", "dqk_ne_dv", "segmented")
# K7's launch-count buckets: the flavour, with "+pv8" under pv_int8
INT8_FLAVOURS = tuple(f + pv for f in FLAVOURS for pv in ("", "+pv8"))
# the kv tile of csrc/flash_attention.cu, over which K7's pv_int8 quantizes v
KERNEL_BLOCK_K = 64
# The forward (K2, K2-lse, K9): the padded (Dqk, Dv) pairs it is built for,
# in the order the plan tries them (csrc/flash_attention.cu `dispatch`); 16 q
# rows per warp; k tiles of 64 keys whatever the shape, in a ring of two
# stages.
FWD_DIMS = ((16, 16), (64, 64), (80, 80), (128, 128), (192, 64), (256, 128))
FWD_BLOCK_K = 64
FWD_STAGES = 2


@dataclass(frozen=True)
class FlashPlan:
    """How one forward call runs: head dims padded to ``dqk_pad``/``dv_pad``
    in shared memory, ``warps`` warps of 16 q rows (``block_q`` rows per
    block), ``block_k`` keys per k tile, ``smem_bytes`` per block."""
    dqk_pad: int
    dv_pad: int
    warps: int
    block_q: int
    block_k: int
    smem_bytes: int


def fwd_warps(dqk_pad: int) -> int:
    """Warps per block (csrc/flash_attention.cu ``warps_for``): six at head
    dims up to 80, four above."""
    return 6 if dqk_pad <= 80 else 4


def fwd_smem_bytes(dqk_pad: int, dv_pad: int, skv: int) -> int:
    """Shared memory of one forward block (csrc/flash_attention.cu
    ``smem_fixed`` plus the k-tile arrays): FWD_STAGES stages of k and v
    tiles in bf16 with 8 elements of row padding, the q tile likewise (a
    64-row one shares the last k stage), as many stages of key segment ids,
    the q rows' segment ids and positions, 8 reduction slots, and four ints
    per k tile (its smallest and largest key segment, whether it holds one
    segment, and the list of visited tiles)."""
    warps = fwd_warps(dqk_pad)
    block_q = 16 * warps
    q_tile = 0 if block_q == FWD_BLOCK_K else block_q * (dqk_pad + 8)
    return (2 * (q_tile + FWD_STAGES * FWD_BLOCK_K * (dqk_pad + 8)
                 + FWD_STAGES * FWD_BLOCK_K * (dv_pad + 8))
            + 4 * (FWD_STAGES * FWD_BLOCK_K + 2 * block_q + 8) + 16 * -(-skv // FWD_BLOCK_K))


@functools.lru_cache(maxsize=1024)
def plan_flash(dqk: int, dv: int, skv: int) -> FlashPlan:
    """The forward kernel's plan for one shape, or ValueError if the kernel
    refuses it. The head dims take the first built pair that holds them.
    Neither the q tile nor the k tile depends on Sq or on where the q rows
    sit in the sequence: the k tile is FWD_BLOCK_K keys, so each row visits
    the same k tiles in the same order in a shard as in the whole sequence,
    which K9's bit equality needs."""
    if not (0 < dqk <= MAX_DQK and 0 < dv <= MAX_DV):
        raise ValueError(f"flash_attention: unsupported head dims {dqk}/{dv}")
    dqk_pad, dv_pad = next((a, b) for a, b in FWD_DIMS if a >= dqk and b >= dv)
    warps = fwd_warps(dqk_pad)
    smem = fwd_smem_bytes(dqk_pad, dv_pad, skv)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_attention: {skv} keys need {smem} bytes of shared memory "
                         f"per block, over the card's {SMEM_LIMIT}")
    return FlashPlan(dqk_pad, dv_pad, warps, 16 * warps, FWD_BLOCK_K, smem)


# The backward (K3, K9's backward), csrc/flash_attention_bwd.cu: built for
# the forward's head-dim pairs, so training never reaches a forward that it
# refuses; four warps of 16 rows, q and k tiles of 64 rows whatever the
# shape, two-stage rings; the dkv kernel's work cut into at most
# BWD_MAX_SPLITS chunks per block.
BWD_DIMS = FWD_DIMS
BWD_BLOCK = 64
BWD_STAGES = 2
BWD_WARPS = 4
BWD_MAX_SPLITS = 8


@dataclass(frozen=True)
class FlashBwdPlan:
    """How one backward call runs: head dims padded to ``dqk_pad``/``dv_pad``
    in shared memory, ``warps`` warps of 16 rows, q and k tiles of ``block``
    rows, ``smem_dq`` and ``smem_dkv`` bytes per block of the two kernels."""
    dqk_pad: int
    dv_pad: int
    warps: int
    block: int
    smem_dq: int
    smem_dkv: int


def bwd_smem_bytes(dqk_pad: int, dv_pad: int, n_tiles: int) -> int:
    """Shared memory of one block of either backward kernel
    (csrc/flash_attention_bwd.cu ``smem_fixed`` plus its tile list): three
    tiles of each head dim in bf16 with 8 elements of row padding (the
    resident one and a two-stage ring), nine 64-entry row vectors (the dkv
    kernel's ring of q-row LSE, dsum, segments and positions, and its key
    segments), 8 slots, and one int per tile of the list (k tiles for dq, q
    tiles for dkv)."""
    return (2 * 3 * BWD_BLOCK * (dqk_pad + 8 + dv_pad + 8) + 4 * (9 * BWD_BLOCK + 8)
            + 4 * n_tiles)


@functools.lru_cache(maxsize=1024)
def plan_flash_bwd(dqk: int, dv: int, sq: int, skv: int) -> FlashBwdPlan:
    """The backward kernels' plan for one shape, or ValueError if they
    refuse it. The head dims take the first built pair that holds them, as
    the forward's do; the k tile is BWD_BLOCK keys whatever Sq, so a q
    shard's rows visit the same k tiles in the same order as in the whole
    sequence (K9's dq equals the monolithic call's bit for bit)."""
    if not (0 < dqk <= MAX_DQK and 0 < dv <= MAX_DV):
        raise ValueError(f"flash_attention_backward: unsupported head dims {dqk}/{dv}")
    dqk_pad, dv_pad = next((a, b) for a, b in BWD_DIMS if a >= dqk and b >= dv)
    smem_dq = bwd_smem_bytes(dqk_pad, dv_pad, -(-skv // BWD_BLOCK))
    smem_dkv = bwd_smem_bytes(dqk_pad, dv_pad, -(-sq // BWD_BLOCK))
    if max(smem_dq, smem_dkv) > SMEM_LIMIT:
        raise ValueError(f"flash_attention_backward: {sq} queries and {skv} keys need "
                         f"{max(smem_dq, smem_dkv)} bytes of shared memory per block, over "
                         f"the card's {SMEM_LIMIT}")
    return FlashBwdPlan(dqk_pad, dv_pad, BWD_WARPS, BWD_BLOCK, smem_dq, smem_dkv)


def bwd_splits(b: int, hkv: int, skv: int, sms: int, causal: bool) -> int:
    """Chunks of each dkv block's (q head, q tile) list, one block each, at
    most BWD_MAX_SPLITS. Under causal masking, whose blocks walk from 1 to
    all q tiles, enough for about four blocks per SM; otherwise every block
    walks the same number and a split only adds its workspace, so none. A
    function of the shape alone, so the same inputs are summed in the same
    order."""
    if not causal:
        return 1
    blocks = b * hkv * -(-skv // BWD_BLOCK)
    return max(1, min(BWD_MAX_SPLITS, -(-4 * sms // blocks)))


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flavour(causal: bool, dense: bool, dqk: int, dv: int, qpos: bool = False) -> str:
    """The launch-count bucket of one call: the first that applies of
    causal (+qpos with q positions), dense, dqk != dv, segmented."""
    if causal:
        return "causal+qpos" if qpos else "causal"
    if dense:
        return "dense"
    return "dqk_ne_dv" if dqk != dv else "segmented"


def allowed_mask(q_segment_ids: Optional[torch.Tensor], kv_segment_ids: Optional[torch.Tensor],
                 b: int, sq: int, skv: int, causal: bool, dense: bool,
                 device, q_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, Sq, Skv] bool: key t is allowed for query s iff the segment ids
    are equal and the query's is >= 0 (all keys when dense), and, when
    causal, t <= s, or t <= q_positions[b, s] when q positions are given."""
    if dense:
        allowed = torch.ones((b, sq, skv), dtype=torch.bool, device=device)
    else:
        qs = q_segment_ids[:, :, None]
        allowed = (qs == kv_segment_ids[:, None, :]) & (qs >= 0)
    if causal:
        pos_q = (torch.arange(sq, device=device)[:, None] if q_positions is None
                 else q_positions.to(device)[:, :, None])
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
                                  causal: bool = False, dense: bool = False,
                                  q_positions: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2, K2-lse and K9: fp32 math from the given inputs.

    q [B, Hq, Sq, Dqk], k [B, Hkv, Skv, Dqk], v [B, Hkv, Skv, Dv]; segment
    ids [B, S] int (ignored when dense); q_positions [B, Sq] int, the causal
    slot of each q row (K9). Returns (out [B, Hq, Sq, Dv] in q's
    dtype, lse [B, Hq, Sq] f32): lse is log2(sum_t 2^(s_t log2 e)), the
    log-sum-exp of the scaled scores in the log2 domain, and -1e30 for a row
    with no allowed key, whose output is 0."""
    b, _, sq, _ = q.shape
    scores, _, vf = _scores(q, k, v)
    allowed = allowed_mask(q_segment_ids, kv_segment_ids, b, sq, k.shape[2], causal, dense,
                           q.device, q_positions)
    scores = scores.masked_fill(~allowed[:, None], NEG_INF)
    seen = allowed.any(-1)[:, None, :]  # [B, 1, Sq]
    lse = torch.logsumexp(scores, dim=-1)  # the softmax's own normalizer
    out = torch.exp(scores - lse[..., None]) @ vf
    out = out.masked_fill(~seen[..., None], 0.0)
    lse = torch.where(seen, lse * LOG2E, torch.full((), NEG_INF, device=q.device))
    return out.to(q.dtype), lse


def flash_attention_reference(q, k, v, q_segment_ids, kv_segment_ids,
                              causal: bool = False, dense: bool = False,
                              q_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K2 and K9: the output of
    ``flash_attention_lse_reference``."""
    return flash_attention_lse_reference(q, k, v, q_segment_ids, kv_segment_ids,
                                         causal, dense, q_positions)[0]


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_segment_ids: Optional[torch.Tensor], kv_segment_ids: Optional[torch.Tensor],
        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
        causal: bool = False, dense: bool = False,
        q_positions: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3 and of K9's backward (with q_positions), in fp32 from the given inputs: the probabilities
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
                           q.device, q_positions)[:, None] & (lse > NEG_INF / 2)[..., None]
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
    st = t.stride()
    if st[3] != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous last dim")
    if max(st) >= 2 ** 31:
        raise ValueError(f"flash_attention: {name} strides exceed int32")
    return st[:3]


def _int32(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """t as a contiguous int32 tensor on ``like``'s device (t itself if it
    is one)."""
    if t.dtype == torch.int32 and t.get_device() == like.get_device() and t.is_contiguous():
        return t
    return t.to(device=like.device, dtype=torch.int32).contiguous()


def _check(q, k, v, q_segment_ids, kv_segment_ids, causal, dense, q_positions=None):
    """Validate a CUDA call -> (segment-id and q-position pointers, the int32
    tensors they point into)."""
    b, hq, sq, dqk = q.shape
    _, hkv, skv, dv = v.shape
    if k.shape != (b, hkv, skv, dqk) or v.shape[0] != b or hq % hkv:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} do not match")
    qpos = None
    if q_positions is not None:
        qpos = _int32(q_positions, q)
        if qpos.shape != (b, sq):
            raise ValueError("flash_attention: q_positions must be [B, Sq]")
    elif causal and sq != skv:
        raise ValueError("flash_attention: causal needs Sq == Skv without q_positions")
    plan_flash(dqk, dv, skv)  # raises on a shape the kernel refuses
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.get_device() == k.get_device() == v.get_device()):
        raise ValueError(f"flash_attention: q, k and v must be bf16 on {q.device}")
    qpos_ptr = None if qpos is None else qpos.data_ptr()
    if dense:
        return (None, None, qpos_ptr), (qpos,)
    qseg = _int32(q_segment_ids, q)
    kseg = _int32(kv_segment_ids, q)
    if qseg.shape != (b, sq) or kseg.shape != (b, skv):
        raise ValueError("flash_attention: segment ids must be [B, Sq] and [B, Skv]")
    return (qseg.data_ptr(), kseg.data_ptr(), qpos_ptr), (qseg, kseg, qpos)


def _device_of(q: torch.Tensor, dense: bool, q_segment_ids, kv_segment_ids,
               causal: bool = False, q_positions=None) -> str:
    if not dense and (q_segment_ids is None or kv_segment_ids is None):
        raise ValueError("flash_attention: segment ids are required unless dense")
    if q_positions is not None and (not causal or dense):
        raise ValueError("flash_attention: q_positions ask for causal, non-dense attention")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return q.device.type


def _launch_forward(q, k, v, q_segment_ids, kv_segment_ids, causal, dense, with_lse,
                    q_positions=None):
    """One launch of the tensor-core forward in csrc/flash_attention.cu ->
    (out, lse or None)."""
    b, hq, sq, dqk = q.shape
    _, hkv, skv, dv = v.shape
    seg_ptrs, _keep = _check(q, k, v, q_segment_ids, kv_segment_ids, causal, dense,
                             q_positions)
    qst, kst, vst = _strides(q, "q"), _strides(k, "k"), _strides(v, "v")
    # out: a [B, Hq, Sq, Dv] view of a fresh [B, Sq, Hq, Dv] buffer
    ost = (sq * hq * dv, dv, hq * dv)
    out = torch.empty_strided((b, hq, sq, dv), (*ost, 1), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    plan = plan_flash(dqk, dv, skv)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    # which rows may move as 16-byte chunks: q, k, v as given; out's strides
    # are multiples of Dv
    vec = (_rows16(qp, qst) | _rows16(kp, kst) << 1 | _rows16(vp, vst) << 2
           | (dv % 8 == 0) << 3)
    # the ints travel as one array: a ctypes call costs ~0.3 us per argument
    ints = array.array("i", (b, hq, hkv, sq, skv, dqk, dv, plan.dqk_pad, plan.dv_pad,
                             plan.smem_bytes, *qst, *kst, *vst, *ost, int(causal), vec))
    fn = kernel_function("flash_attention", "flash_attention_bf16", [ctypes.c_void_p] * 10)
    rc = fn(qp, kp, vp, out.data_ptr(), None if lse is None else lse.data_ptr(), *seg_ptrs,
            ints.buffer_info()[0], current_stream(q.device))
    check_launch(rc, "flash_attention")
    return out, lse


def _rows16(ptr: int, strides) -> bool:
    """Whether every row of a bf16 [B, H, S, D] view at ``ptr`` with these
    strides (its last dim contiguous) starts on a 16-byte boundary."""
    return ptr % 16 == 0 and (strides[0] | strides[1] | strides[2]) % 8 == 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        causal: bool = False, dense: bool = False,
                        q_positions: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-lse (K9-lse with q_positions): ``flash_attention``'s output and the
    per-row log2-domain LSE [B, Hq, Sq] f32 (-1e30 on rows with no allowed
    key), which K3 reads. ``flash_attention_lse.launches[flavour]`` counts
    kernel launches."""
    if _device_of(q, dense, q_segment_ids, kv_segment_ids, causal, q_positions) == "cpu":
        return flash_attention_lse_reference(q, k, v, q_segment_ids, kv_segment_ids,
                                             causal, dense, q_positions)
    out, lse = _launch_forward(q, k, v, q_segment_ids, kv_segment_ids, causal, dense, True,
                               q_positions)
    if out.numel():
        flash_attention_lse.launches[flavour(causal, dense, q.shape[-1], v.shape[-1],
                                             q_positions is not None)] += 1
    return out, lse


def flash_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_segment_ids: Optional[torch.Tensor], kv_segment_ids: Optional[torch.Tensor],
        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
        causal: bool = False, dense: bool = False,
        q_positions: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 (K9's backward with q_positions): (dq, dk, dv) of attention from
    the forward's output and LSE. With q_positions, dk and dv are the part
    of this q shard; summing them over the shards gives the whole.

    On the card one call of csrc/flash_attention_bwd.cu launches the dq
    kernel (whose prologue also computes dsum = rowsum(dO * O), which the
    JAX package computes outside Pallas, :818), the dkv kernel and, when
    the dkv work is split, the kernel that sums its fp32 parts (the
    workspaces are allocated here); it writes dq, dk, dv as [B, H, S, D]
    views of [B, S, H, D] buffers. ``flash_attention_backward.launches[flavour]``
    counts these calls; ``flash_attention_backward.last_split`` holds the
    last launch's dkv chunks (``bwd_splits``) and workspace bytes."""
    if _device_of(q, dense, q_segment_ids, kv_segment_ids, causal, q_positions) == "cpu":
        return flash_attention_backward_reference(q, k, v, q_segment_ids, kv_segment_ids,
                                                  out, lse, dout, causal, dense, q_positions)
    b, hq, sq, dqk = q.shape
    _, hkv, skv, dv = v.shape
    seg_ptrs, _keep = _check(q, k, v, q_segment_ids, kv_segment_ids, causal, dense,
                             q_positions)
    if out.shape != (b, hq, sq, dv) or dout.shape != out.shape or lse.shape != (b, hq, sq):
        raise ValueError("flash_attention_backward: out, dout or lse has the wrong shape")
    plan = plan_flash_bwd(dqk, dv, sq, skv)
    dout, out = (x if x.dtype == torch.bfloat16 and x.stride(-1) == 1
                 else x.to(torch.bfloat16).contiguous() for x in (dout, out))
    lse = lse.to(torch.float32).contiguous()
    dsum = torch.empty_like(lse)  # rowsum(dO * O), the dq kernel writes it
    dq = torch.empty((b, sq, hq, dqk), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((b, skv, hkv, dqk), dtype=k.dtype, device=q.device).transpose(1, 2)
    dvv = torch.empty((b, skv, hkv, dv), dtype=v.dtype, device=q.device).transpose(1, 2)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dvv.zero_()
    splits = bwd_splits(b, hkv, skv, _sm_count(q.get_device()), causal)
    ws = (torch.empty((b, hkv, splits, skv, plan.dqk_pad + plan.dv_pad), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    qst, kst, vst, dost, ost = (_strides(q, "q"), _strides(k, "k"), _strides(v, "v"),
                                _strides(dout, "dout"), _strides(out, "out"))
    qp, kp, vp, dop, op = q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), out.data_ptr()
    # rows that may move as 16-byte chunks (q, k, v, dO, O), outputs whose
    # rows take 4-byte pairs (dq and dk, dv: even widths of fresh buffers)
    vec = (_rows16(qp, qst) | _rows16(kp, kst) << 1 | _rows16(vp, vst) << 2
           | _rows16(dop, dost) << 3 | (dqk % 2 == 0) << 4 | (dv % 2 == 0) << 5
           | _rows16(op, ost) << 6)
    ints = array.array("i", (b, hq, hkv, sq, skv, dqk, dv, plan.dqk_pad, plan.dv_pad,
                             plan.smem_dq, plan.smem_dkv, splits, *qst, *kst, *vst, *dost,
                             *ost, *dq.stride()[:3], *dk.stride()[:3], *dvv.stride()[:3],
                             int(causal), vec))
    fn = kernel_function("flash_attention_bwd", "flash_attention_bwd_bf16",
                         [ctypes.c_void_p] * 16)
    rc = fn(qp, kp, vp, dop, op, lse.data_ptr(), dsum.data_ptr(), *seg_ptrs, dq.data_ptr(),
            dk.data_ptr(), dvv.data_ptr(), None if ws is None else ws.data_ptr(),
            ints.buffer_info()[0], current_stream(q.device))
    check_launch(rc, "flash_attention_backward")
    flash_attention_backward.last_split = {"splits": splits,
                                           "workspace_bytes": 0 if ws is None else ws.nbytes}
    flash_attention_backward.launches[flavour(causal, dense, dqk, dv,
                                              q_positions is not None)] += 1
    return dq, dk, dvv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention: K2-lse forward, K3 backward (K9's
    flavours with q positions; their plain versions on CPU tensors).
    Segment ids, q positions and flags get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, causal: bool, dense: bool,
                q_positions=None):
        out, lse = flash_attention_lse(q, k, v, q_segment_ids, kv_segment_ids, causal, dense,
                                       q_positions)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, q_positions, out, lse)
        ctx.flags = (causal, dense)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qseg, kseg, qpos, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, qseg, kseg, out, lse, dout, *ctx.flags,
                                              q_positions=qpos)
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------- K7

def default_block_k(skv: int) -> int:
    """The JAX package's kv tile for the int8 tier (flash_attention.py:457)."""
    return 2048 if skv % 2048 == 0 else 1024


def flash_attention_int8_reference(
        q_i8: torch.Tensor, k_i8: torch.Tensor, v: torch.Tensor, q_scale: torch.Tensor,
        k_scale: torch.Tensor, q_segment_ids: Optional[torch.Tensor],
        kv_segment_ids: Optional[torch.Tensor], causal: bool = False, dense: bool = False,
        pv_int8: bool = False, block_k: int = KERNEL_BLOCK_K,
        out_dtype: torch.dtype = torch.bfloat16,
        q_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K7 (K9-int8 with q_positions): the online softmax over kv tiles of ``block_k``
    keys, in fp32, as the kernel runs it. Scores are the exact integer
    q_i8 . k_i8 times (q_scale * sm_scale * log2 e) * k_scale; with pv_int8
    each tile's probabilities are rounded to p * 127 and its v quantized
    per column (amax / 127 over the tile's rows), and the tile's product is
    an exact integer sum times v_scale / 127. Rows with no allowed key
    output 0. Returns [B, Hq, Sq, Dv] in out_dtype."""
    b, hq, sq, d = q_i8.shape
    skv = k_i8.shape[2]
    g = hq // k_i8.shape[1]
    scale2 = (1.0 / d ** 0.5) * LOG2E
    allowed = allowed_mask(q_segment_ids, kv_segment_ids, b, sq, skv, causal, dense,
                           q_i8.device, q_positions)[:, None]
    qf = q_i8.float()
    kf = k_i8.float().repeat_interleave(g, dim=1)
    ksc = k_scale.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    qsc = q_scale.float()[..., None] * scale2
    m = torch.full((b, hq, sq, 1), NEG_INF, device=q_i8.device)
    l = torch.zeros((b, hq, sq, 1), device=q_i8.device)
    acc = torch.zeros((b, hq, sq, v.shape[-1]), device=q_i8.device)
    for j0 in range(0, skv, block_k):
        sl = slice(j0, j0 + block_k)
        ok = allowed[..., sl]
        s = (qf @ kf[:, :, sl].transpose(-1, -2)) * qsc * ksc[:, :, None, sl]
        s = s.masked_fill(~ok, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new).masked_fill(~ok, 0.0)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        vt = vf[:, :, sl]
        if pv_int8:
            vsc = vt.abs().amax(-2, keepdim=True).clamp(min=1e-8) / 127.0
            v_i8 = torch.clamp(torch.round(vt / vsc), -127, 127)
            pv = (torch.round(p * 127.0).double() @ v_i8.double()).float()
            acc = acc * alpha + pv * (vsc * (1.0 / 127.0))
        else:
            acc = acc * alpha + p @ vt
        m = m_new
    out = acc / l.clamp(min=1e-30)
    return out.masked_fill(~(m > NEG_INF / 2), 0.0).to(out_dtype)


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_segment_ids: Optional[torch.Tensor] = None,
                         kv_segment_ids: Optional[torch.Tensor] = None,
                         causal: bool = False, dense: bool = False, pv_int8: bool = False,
                         block_k: Optional[int] = None,
                         q_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 (K9-int8 with q_positions): attention with per-row int8 q and k (and, with pv_int8, an int8
    PV product) -> [B, Hq, Sq, Dv] in q's dtype; layouts as
    ``flash_attention``. q and k are quantized here (plain PyTorch, as JAX
    does outside its kernel). block_k is the kv tile over which pv_int8
    quantizes v: on the CPU it defaults to the JAX package's tile; on the
    card it is the kernel's, ``KERNEL_BLOCK_K``, and another value raises.
    ``flash_attention_int8.launches[flavour(+pv8)]`` counts kernel
    launches."""
    device = _device_of(q, dense, q_segment_ids, kv_segment_ids, causal, q_positions)
    q8, qsc = quantize_kv(q)  # per-row int8, JAX's _quant_rows_i8 (:232)
    k8, ksc = quantize_kv(k)
    if device == "cpu":
        return flash_attention_int8_reference(
            q8, k8, v, qsc, ksc, q_segment_ids, kv_segment_ids, causal, dense, pv_int8,
            block_k or default_block_k(k.shape[2]), q.dtype, q_positions)
    if block_k not in (None, KERNEL_BLOCK_K):
        raise ValueError(f"flash_attention_int8: the kernel's kv tile is {KERNEL_BLOCK_K}")
    b, hq, sq, dqk = q.shape
    _, hkv, skv, dv = v.shape
    seg_ptrs, _keep = _check(q, k, v, q_segment_ids, kv_segment_ids, causal, dense,
                             q_positions)
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = _strides(q8, "q") + _strides(k8, "k") + _strides(v, "v")
    qsc, ksc = qsc.contiguous(), ksc.contiguous()  # indexed as [B, H, S]
    fn = kernel_function("flash_attention", "flash_attention_i8",
                         [ctypes.c_void_p] * 9 + [ctypes.c_int] * 21 + [ctypes.c_void_p])
    rc = fn(q8.data_ptr(), k8.data_ptr(), v.data_ptr(), out.data_ptr(), qsc.data_ptr(),
            ksc.data_ptr(), *seg_ptrs, b, hq, hkv, sq, skv, dqk, dv, *strides,
            *out.stride()[:3], int(causal), int(pv_int8),
            current_stream(q.device))
    check_launch(rc, "flash_attention_int8")
    fl = flavour(causal, dense, dqk, dv, q_positions is not None) + ("+pv8" if pv_int8 else "")
    flash_attention_int8.launches[fl] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    causal: bool = False, dense: bool = False, qkv_int8: bool = False,
                    pv_int8: bool = False, block_k: Optional[int] = None,
                    q_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q [B, Hq, Sq, Dqk] over k [B, Hkv, Skv, Dqk] and
    v [B, Hkv, Skv, Dv] -> [B, Hq, Sq, Dv].

    q, k and v may be strided views (the last dim must be contiguous). On
    the card the output is a [B, Hq, Sq, Dv] view of a [B, Sq, Hq, Dv]
    buffer, so ``out.transpose(1, 2)`` is contiguous. When autograd records
    a graph through q, k or v, the call goes through
    ``FlashAttentionFunction`` (K2-lse, then K3 in the backward); otherwise
    it is one K2 launch, counted in ``flash_attention.launches[flavour]``.

    qkv_int8 (with pv_int8, block_k) selects K7, ``flash_attention_int8``:
    the int8 serving tier, inference only, so it raises while autograd
    records, as the JAX tier has no VJP.

    q_positions [B, Sq] int (K9; needs causal and segment ids): q is a
    shard of the sequence that k and v hold whole, and q row s is the
    sequence's slot q_positions[b, s]; causal allows key t iff t <=
    q_positions[b, s]. Each row's output equals the monolithic call's."""
    if pv_int8 and not qkv_int8:
        raise ValueError("flash_attention: pv_int8 rides the qkv_int8 tier")
    if qkv_int8:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            raise ValueError("flash_attention: the int8 tier is inference only (no backward)")
        return flash_attention_int8(q, k, v, q_segment_ids, kv_segment_ids, causal, dense,
                                    pv_int8, block_k, q_positions)
    device = _device_of(q, dense, q_segment_ids, kv_segment_ids, causal, q_positions)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, q_segment_ids, kv_segment_ids,
                                            causal, dense, q_positions)
    if device == "cpu":
        return flash_attention_reference(q, k, v, q_segment_ids, kv_segment_ids, causal, dense,
                                         q_positions)
    out, _ = _launch_forward(q, k, v, q_segment_ids, kv_segment_ids, causal, dense, False,
                             q_positions)
    if out.numel():
        flash_attention.launches[flavour(causal, dense, q.shape[-1], v.shape[-1],
                                         q_positions is not None)] += 1
    return out


flash_attention.launches = dict.fromkeys(FLAVOURS, 0)
flash_attention_lse.launches = dict.fromkeys(FLAVOURS, 0)
flash_attention_backward.launches = dict.fromkeys(FLAVOURS, 0)
flash_attention_backward.last_split = {"splits": 0, "workspace_bytes": 0}
flash_attention_int8.launches = dict.fromkeys(INT8_FLAVOURS, 0)

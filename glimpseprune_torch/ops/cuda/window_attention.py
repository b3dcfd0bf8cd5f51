"""K1 and K8: attention inside the ViT's 64-patch windows.

K1 (``window_attention_fused``) fuses rope into the attention and replaces
the Pallas kernel ``window_attention_fused``
(glimpseprune_tpu/ops/pallas/window_attention.py:133, body ``_fused_kernel``
:55). K8 (``window_attention``) attends on q, k, v that already carry rope
and replaces the Pallas kernel ``window_attention`` (:198, body ``_kernel``
:31); the ViT takes it only in a windowed block that emits importance. Both
are entry points of ``glimpseprune_torch/csrc/window_attention.cu`` over
one kernel body, whose header says what bounds it on the H100 and how the
design answers.

The Pallas version merges W=2 windows per grid step, which was TPU tuning;
here one block handles one window and a group of heads, as ``plan_window``
(the pure host-side plan: padded head dim, heads per block, shared-memory
bytes) chooses.

Dispatch is by device: a CPU tensor takes the plain PyTorch version below,
a CUDA tensor launches the kernel (or raises).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from glimpseprune_torch.ops.cuda.build import check_launch, current_stream, kernel_function
from glimpseprune_torch.ops.rope import rotate_half

NEG_INF = -1e30
MAX_WP = 64  # rows and keys of a window tile
MAX_DIM = 128
# the padded head dims csrc/window_attention.cu is built for
WINDOW_DIMS = (16, 64, 80, 128)


@dataclass(frozen=True)
class WindowPlan:
    """How one K1/K8 call runs: the head dim padded to ``dim_pad`` in shared
    memory, ``heads_per_block`` heads per (window, head group) block,
    ``smem_bytes`` per block."""
    dim_pad: int
    heads_per_block: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def plan_window(dim: int, wp: int, heads: int, rope: bool) -> WindowPlan:
    """The window kernel's plan, or ValueError if it refuses the shape.
    Shared memory holds q, k and v (and with rope cos and sin) as
    [64][dim_pad + 8] bf16 tiles and 64 validity flags. Four heads share a
    block where the head count allows: the 7B's 80 windows then give 320
    blocks, and cos and sin are read once per block."""
    if not 0 < wp <= MAX_WP or not 0 < dim <= MAX_DIM or (rope and dim % 2):
        raise ValueError(f"window_attention: unsupported wp={wp}, D={dim}")
    dim_pad = next(d for d in WINDOW_DIMS if d >= dim)
    hg = next(g for g in (4, 2, 1) if heads % g == 0)
    smem = 2 * MAX_WP * (dim_pad + 8) * (5 if rope else 3) + 4 * MAX_WP
    return WindowPlan(dim_pad, hg, smem)


def _launch(entry: str, pointers, out, p, h, d, wp, rope, vec) -> None:
    plan = plan_window(d, wp, h, rope)
    fn = kernel_function("window_attention", entry,
                         [ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * 8
                         + [ctypes.c_void_p])
    rc = fn(*pointers, p, h, d, wp, plan.dim_pad, plan.heads_per_block, plan.smem_bytes, vec,
            current_stream(out.device))
    check_launch(rc, entry)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def window_attention_fused_reference(qkv: torch.Tensor, cos: torch.Tensor,
                                     sin: torch.Tensor, valid: torch.Tensor,
                                     wp: int) -> torch.Tensor:
    """Plain version: fp32 math from the given inputs, output in qkv's dtype.

    qkv [P, 3, H, D] pre-rope; cos/sin [P, D]; valid [P] bool; P = n_win*wp.
    Keys are masked to valid keys plus the diagonal (pad rows attend to
    themselves, so every row is defined)."""
    p, _, h, d = qkv.shape
    nw = p // wp
    x = qkv.float()
    c = cos.float()[:, None, :]
    s = sin.float()[:, None, :]
    q = x[:, 0] * c + rotate_half(x[:, 0]) * s
    k = x[:, 1] * c + rotate_half(x[:, 1]) * s
    v = x[:, 2]

    def windows(t):
        return t.reshape(nw, wp, h, d).transpose(1, 2)  # [nw, H, wp, D]

    scores = windows(q) @ windows(k).transpose(-1, -2) * (1.0 / d ** 0.5)
    eye = torch.eye(wp, dtype=torch.bool, device=qkv.device)
    allowed = valid.reshape(nw, 1, 1, wp) | eye
    probs = torch.softmax(scores.masked_fill(~allowed, NEG_INF), dim=-1)
    out = probs @ windows(v)
    return out.transpose(1, 2).reshape(p, h, d).to(qkv.dtype)


def window_attention_fused(qkv: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor, valid: torch.Tensor,
                           wp: int) -> torch.Tensor:
    """Rope + attention inside each window of ``wp`` patches -> [P, H, D].

    ``window_attention_fused.launches`` counts kernel launches."""
    if qkv.device.type == "cpu":
        return window_attention_fused_reference(qkv, cos, sin, valid, wp)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_fused: unsupported device {qkv.device}")
    p, three, h, d = qkv.shape
    if three != 3 or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("window_attention_fused: qkv must be contiguous bf16 [P, 3, H, D]")
    if p % wp:
        raise ValueError(f"window_attention_fused: P={p} is not a multiple of wp={wp}")
    plan_window(d, wp, h, True)  # raises on a shape the kernel refuses
    for name, t in (("cos", cos), ("sin", sin)):
        if t.shape != (p, d) or t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != qkv.device:
            raise ValueError(f"window_attention_fused: {name} must be contiguous bf16 [P, D]")
    if valid.shape != (p,) or valid.dtype != torch.bool or not valid.is_contiguous() \
            or valid.device != qkv.device:
        raise ValueError("window_attention_fused: valid must be contiguous bool [P]")
    out = torch.empty((p, h, d), dtype=qkv.dtype, device=qkv.device)
    if p == 0:
        return out
    rows16 = d % 8 == 0
    vec = (int(rows16 and _aligned(qkv)) + 2 * int(rows16 and _aligned(cos, sin))
           + 4 * int(rows16 and _aligned(out)))
    _launch("window_attention_fused_bf16",
            (qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), valid.data_ptr(), out.data_ptr()),
            out, p, h, d, wp, True, vec)
    window_attention_fused.launches += 1
    return out


window_attention_fused.launches = 0


def window_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               valid: torch.Tensor, wp: int) -> torch.Tensor:
    """Plain version of K8: fp32 math from the given inputs, output in q's
    dtype. q/k/v [P, H, D] with rope applied; valid [P] bool; P = n_win*wp.
    As the Pallas ``_kernel``: q scaled by 1/sqrt(D), keys masked to the
    window's valid keys plus the diagonal, softmax, then PV."""
    p, h, d = q.shape
    nw = p // wp

    def windows(t):
        return t.float().reshape(nw, wp, h, d).transpose(1, 2)  # [nw, H, wp, D]

    scores = (windows(q) * (1.0 / d ** 0.5)) @ windows(k).transpose(-1, -2)
    eye = torch.eye(wp, dtype=torch.bool, device=q.device)
    allowed = valid.reshape(nw, 1, 1, wp) | eye
    probs = torch.softmax(scores.masked_fill(~allowed, NEG_INF), dim=-1)
    out = probs @ windows(v)
    return out.transpose(1, 2).reshape(p, h, d).to(q.dtype)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, wp: int) -> torch.Tensor:
    """Attention inside each window of ``wp`` patches on roped q, k, v
    [P, H, D] -> [P, H, D]. ``window_attention.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, valid, wp)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    p, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != (p, h, d) or t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"window_attention: {name} must be contiguous bf16 [P, H, D] "
                             "on q's device")
    if p % wp:
        raise ValueError(f"window_attention: P={p} is not a multiple of wp={wp}")
    plan_window(d, wp, h, False)  # raises on a shape the kernel refuses
    if valid.shape != (p,) or valid.dtype != torch.bool or not valid.is_contiguous() \
            or valid.device != q.device:
        raise ValueError("window_attention: valid must be contiguous bool [P]")
    out = torch.empty((p, h, d), dtype=q.dtype, device=q.device)
    if p == 0:
        return out
    rows16 = d % 8 == 0
    vec = int(rows16 and _aligned(q, k, v)) + 4 * int(rows16 and _aligned(out))
    _launch("window_attention_bf16",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr()),
            out, p, h, d, wp, False, vec)
    window_attention.launches += 1
    return out


window_attention.launches = 0

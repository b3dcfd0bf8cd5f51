"""Shared building blocks: Linear, QuantLinear, RMSNorm, gated MLP,
activations.

Counterpart of glimpseprune_tpu/models/layers.py, and of the two ``_dense``
copies of the JAX towers (models/qwen2_5_vl/language.py:42-82,
vision.py:48-79), which ``Linear`` and ``QuantLinear`` replace: each takes
the W8A8 flag ``a8`` per call. Module and parameter names follow the Flax
names so the weight bridge (convert.py) maps them one to one.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from glimpseprune_torch.quantization import (
    matmul_int4_auto,
    matmul_w8a8,
    quantize_int4,
    quantize_int8,
)

ACT2FN = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu's default
    "relu": F.relu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


class Linear(nn.Linear):
    """nn.Linear computed in its input's dtype. The trainable GlimpsePrune
    modules keep fp32 weights under a bf16 model (as the JAX params are fp32
    with a bf16 compute dtype); the cast is a no-op where the dtypes agree,
    and gradients reach the fp32 weights through it."""

    def forward(self, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
        """a8 (the W8A8 flag) has no effect on unquantized weights, as in
        the JAX ``_dense``."""
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class QuantLinear(nn.Module):
    """A Linear over quantized weights, in the JAX package's layout
    (quantization.py): int8 ``kernel_q`` [in, out] with f32 ``kernel_scale``
    [1, out], or int4 ``kernel_q4`` [in/2, out] with f32 ``kernel_scale4``
    [in/g, out]; plus the bias in the model dtype. The product runs in the
    input's dtype:

    - int8 with a8: ``matmul_w8a8`` (per-row int8 activations, int32 sums);
    - int8 otherwise: the weight dequantized in the input's dtype, then one
      matmul (JAX: ``kernel_q.astype(dtype) * kernel_scale.astype(dtype)``);
    - int4: ``matmul_int4_auto``, which routes to K4, K6 or
      dequantize-then-matmul by the JAX package's shape gates.

    The scales stay f32 when the module is cast to another dtype. The
    buffers' memory order is fixed whichever way they arrive (quantized
    here or loaded): int4 ``kernel_q4`` row-major, which K4 and K6 read
    along N; int8 ``kernel_q`` column-major, the order in which
    ``torch._int_mm`` takes its fast path (5.9x faster at the 7B's widest
    shape on the H100, PERF.md)."""

    _SCALES = ("kernel_scale", "kernel_scale4")

    def __init__(self, buffers: Dict[str, torch.Tensor], bias: Optional[torch.Tensor]):
        super().__init__()
        self.mode = "int4" if "kernel_q4" in buffers else "int8"
        for name, t in buffers.items():
            self.register_buffer(name, t)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self._set_layout()

    def _set_layout(self):
        if self.mode == "int4":
            self.kernel_q4 = self.kernel_q4.contiguous()
            self.kernel_scale4 = self.kernel_scale4.contiguous()
        else:
            self.kernel_q = self.kernel_q.t().contiguous().t()

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._set_layout()

    @classmethod
    def from_linear(cls, lin: nn.Linear, mode: str) -> "QuantLinear":
        """Quantize lin's weight on its device ("int4" falls back to int8
        where no group splits the contraction dim, as in JAX)."""
        w = lin.weight.detach().t()  # [in, out]
        buffers = quantize_int4(w) if mode == "int4" else quantize_int8(w)
        return cls(buffers, None if lin.bias is None else lin.bias.detach())

    def _apply(self, fn, recurse=True):
        scales = {n: self._buffers[n] for n in self._SCALES if n in self._buffers}
        super()._apply(fn, recurse)
        for n, t in scales.items():  # follow the device, keep f32
            if not t.is_meta:
                self._buffers[n] = t.to(self._buffers[n].device)
        return self

    def forward(self, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
        dtype = x.dtype
        if self.mode == "int4":
            y = matmul_int4_auto(x, self.kernel_q4, self.kernel_scale4, dtype, a8)
        elif a8:
            y = matmul_w8a8(x, self.kernel_q, self.kernel_scale, dtype)
        else:
            y = x @ (self.kernel_q.to(dtype) * self.kernel_scale.to(dtype))
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class RMSNorm(nn.Module):
    """Qwen2-style RMSNorm: fp32 variance and scale, cast back to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (self.weight.float() * xf).to(x.dtype)


class GatedMLP(nn.Module):
    """down(act(gate(x)) * up(x))."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 hidden_act: str = "silu", bias: bool = False):
        super().__init__()
        self.act = ACT2FN[hidden_act]
        self.gate_proj = Linear(hidden_size, intermediate_size, bias=bias)
        self.up_proj = Linear(hidden_size, intermediate_size, bias=bias)
        self.down_proj = Linear(intermediate_size, hidden_size, bias=bias)

    def forward(self, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
        return self.down_proj(self.act(self.gate_proj(x, a8)) * self.up_proj(x, a8), a8)

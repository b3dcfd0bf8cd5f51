"""Shared building blocks: Linear, QuantLinear, RMSNorm, LayerNorm, gated
MLP, activations, and the in-layer LoRA adapters.

Counterpart of glimpseprune_tpu/models/layers.py, and of the two ``_dense``
copies of the JAX towers (models/qwen2_5_vl/language.py:42-82,
vision.py:48-79), which ``Linear`` and ``QuantLinear`` replace: each takes
the W8A8 flag ``a8`` per call. Module and parameter names follow the Flax
names so the weight bridge (convert.py) maps them one to one.

LoRA (JAX ``_dense`` with ``lora_a`` / ``lora_b`` leaves, language.py:42-84):
a Linear or QuantLinear may carry fp32 ``lora_a`` [in, r] and ``lora_b``
[r, out] and then adds (x @ a) @ b, both cast to x's dtype, before its
bias. An adapted layer runs without A8, as the JAX ``_dense`` does: W8A8
becomes the weight-only int8 product and W4A8 the int4 product's A16
route. ``lora_disabled(model)`` skips every adapter for its duration (the
reference policy's forward); the base weights are never touched, so the
policy and the reference are one module with one copy of the weights.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator, Optional, Tuple

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


class _Adapted:
    """The LoRA slots of a Linear or QuantLinear: ``lora_a`` / ``lora_b``
    parameters (None until ``attach_lora``), kept fp32 whatever dtype the
    module is cast to, and ``lora_off``, set by ``lora_disabled``."""

    def _init_lora(self) -> None:
        self.register_parameter("lora_a", None)
        self.register_parameter("lora_b", None)
        self.lora_off = False

    def lora_active(self) -> bool:
        return self.lora_a is not None and not self.lora_off

    def _lora(self, x: torch.Tensor) -> torch.Tensor:
        return (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype)

    def _keep_lora_fp32(self) -> None:
        for name in ("lora_a", "lora_b"):
            p = self._parameters[name]
            if p is not None and not p.is_meta and p.dtype != torch.float32:
                p.data = p.data.float()


class Linear(_Adapted, nn.Linear):
    """nn.Linear computed in its input's dtype. The trainable GlimpsePrune
    modules keep fp32 weights under a bf16 model (as the JAX params are fp32
    with a bf16 compute dtype); the cast is a no-op where the dtypes agree,
    and gradients reach the fp32 weights through it."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_lora()

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self._keep_lora_fp32()
        return self

    def forward(self, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
        """a8 (the W8A8 flag) has no effect on unquantized weights, as in
        the JAX ``_dense``."""
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if not self.lora_active():
            return F.linear(x, self.weight.to(x.dtype), bias)
        y = F.linear(x, self.weight.to(x.dtype)) + self._lora(x)
        return y if bias is None else y + bias


class QuantLinear(_Adapted, nn.Module):
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

    An active adapter turns a8 off (JAX language.py:43, :67).

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
        self._init_lora()
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
        q = cls(buffers, None if lin.bias is None else lin.bias.detach())
        q.lora_a, q.lora_b, q.lora_off = lin.lora_a, lin.lora_b, lin.lora_off
        return q

    @property
    def in_features(self) -> int:
        return (2 * self.kernel_q4.shape[0] if self.mode == "int4"
                else self.kernel_q.shape[0])

    @property
    def out_features(self) -> int:
        return (self.kernel_scale4 if self.mode == "int4" else self.kernel_scale).shape[-1]

    def _apply(self, fn, recurse=True):
        scales = {n: self._buffers[n] for n in self._SCALES if n in self._buffers}
        super()._apply(fn, recurse)
        for n, t in scales.items():  # follow the device, keep f32
            if not t.is_meta:
                self._buffers[n] = t.to(self._buffers[n].device)
        self._keep_lora_fp32()
        return self

    def forward(self, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
        dtype = x.dtype
        adapted = self.lora_active()
        a8 = a8 and not adapted
        if self.mode == "int4":
            y = matmul_int4_auto(x, self.kernel_q4, self.kernel_scale4, dtype, a8)
        elif a8:
            y = matmul_w8a8(x, self.kernel_q, self.kernel_scale, dtype)
        else:
            y = x @ (self.kernel_q.to(dtype) * self.kernel_scale.to(dtype))
        if adapted:
            y = y + self._lora(x)
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


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-6, a scale and a bias; the mean and
    variance E[x^2] - E[x]^2 reduced in fp32), cast back to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


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


def adapted_modules(module: nn.Module) -> Iterator[Tuple[str, "_Adapted"]]:
    """(name, module) of every Linear or QuantLinear in module that carries
    an adapter."""
    for name, m in module.named_modules():
        if isinstance(m, _Adapted) and m.lora_a is not None:
            yield name, m


def attach_lora(modules: Iterable["_Adapted"], rank: int) -> None:
    """Give each Linear or QuantLinear of ``modules`` zero fp32 adapters of
    ``rank``, frozen, on the module's device (the JAX init's slots: zeros,
    adapters off)."""
    for lin in modules:
        dev = next(iter([*lin.parameters(), *lin.buffers()])).device
        lin.lora_a = nn.Parameter(torch.zeros(lin.in_features, rank, device=dev),
                                  requires_grad=False)
        lin.lora_b = nn.Parameter(torch.zeros(rank, lin.out_features, device=dev),
                                  requires_grad=False)


def lora_rank(module: nn.Module) -> int:
    """The rank of module's adapters, 0 without any; a mix of ranks raises."""
    ranks = {m.lora_a.shape[1] for _, m in adapted_modules(module)}
    if len(ranks) > 1:
        raise ValueError(f"adapters of several ranks: {sorted(ranks)}")
    return ranks.pop() if ranks else 0


def lora_state(module: nn.Module) -> Tuple[int, bool, Tuple[int, ...]]:
    """(rank, whether the adapters are on, the adapters' addresses): what a
    captured step of module bakes in. A step reads the adapters by address,
    so adapters put in anew (``remove_lora`` then ``insert_lora``) make
    another state, while an update in place keeps it."""
    mods = [m for _, m in adapted_modules(module)]
    return (mods[0].lora_a.shape[1] if mods else 0,
            bool(mods) and not any(m.lora_off for m in mods),
            tuple(p.data_ptr() for m in mods for p in (m.lora_a, m.lora_b)))


@contextlib.contextmanager
def lora_disabled(model: nn.Module):
    """Run model without its adapters for the duration: every adapted layer
    computes its base product alone (and W8A8 / W4A8 again where the config
    asks for them), as the JAX package's forward over the frozen params
    without LoRA leaves does."""
    mods = [m for _, m in adapted_modules(model)]
    before = [m.lora_off for m in mods]
    for m in mods:
        m.lora_off = True
    try:
        yield model
    finally:
        for m, off in zip(mods, before):
            m.lora_off = off

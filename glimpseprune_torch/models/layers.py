"""Shared building blocks: Linear, RMSNorm, gated MLP, activations.

Counterpart of glimpseprune_tpu/models/layers.py. Module and parameter
names follow the Flax names so the weight bridge (convert.py) maps them
one to one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(self.act(self.gate_proj(x)) * self.up_proj(x))

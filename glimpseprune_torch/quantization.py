"""Weight quantization tiers: int8 per output channel, int4 per group of 64
contraction rows, and the dynamic W8A8 activation tier.

Counterpart of glimpseprune_tpu/quantization.py (``DEFAULT_INCLUDE`` :44,
``matmul_w8a8`` :55, ``quantize_int8`` :84, ``_int4_group`` :121,
``quantize_int4`` :131, ``dequant_int4`` :194, ``matmul_int4_auto`` :213,
``dequantize_int8`` :259, ``quantized_bytes`` :280, ``quantized_config``
:326). The functions work on torch tensors on any device. A quantized
kernel keeps the JAX package's layout and packing, so the same weights give
the same bytes in both packages:

    int8: kernel_q int8 [..., in, out], kernel_scale f32 [..., 1, out]
    int4: kernel_q4 int8 [..., in/2, out], row r in the low nibble and row
          r + in/2 in the high nibble (block-halves packing),
          kernel_scale4 f32 [..., in/g, out]

``np.rint`` and ``torch.round`` both round half to even, and every scale is
computed with the same fp32 operations in the same order.
``models/layers.QuantLinear`` holds these buffers and routes each product
(``matmul_int4_auto``); ``quantize_model`` swaps a model's Linears for it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Sequence

import torch

from glimpseprune_torch.ops.cuda.int4_matmul import (
    int4_decode,
    kernel_applicable,
    matmul_int4,
    matmul_int4_prefill,
    prefill_routable,
    unpack_int4,
)
from glimpseprune_torch.ops.kv_cache import quantize_kv

# the kernels worth quantizing, as JAX parameter paths: the decoder layers,
# the LM head and the ViT blocks (the GlimpsePrune modules, norms, biases,
# embeddings, the patch embed and the merger stay in the model dtype)
DEFAULT_INCLUDE: Sequence[str] = (
    r"text/layers/.*/kernel",
    r"text/lm_head/kernel",
    r"visual/blocks/.*/kernel",
)
INT4_GROUP = 64  # contraction rows per int4 scale


def _match(path: str, patterns: Sequence[str]) -> bool:
    return any(re.fullmatch(p, path) for p in patterns)


def matmul_w8a8(x: torch.Tensor, kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Dynamic W8A8: x [..., K] quantized per row to int8, an int8 x int8
    -> int32 product with kernel_q int8 [K, N], then the rank-1 rescale
    (row amax / 127) x kernel_scale f32 [1, N] -> [..., N] in dtype.

    The JAX package leaves the product to XLA's dot_general (no Pallas
    kernel). On the card it is ``torch._int_mm``, which takes M > 16 rows
    and K, N multiples of 8: the rows are padded to 17 and K and N to
    multiples of 8 with zeros, which add nothing to the sums, keeping the
    weight column-major (QuantLinear's order, _int_mm's fast path). On the
    CPU it is an exact int32 product."""
    lead, k = x.shape[:-1], x.shape[-1]
    xq, xs = quantize_kv(x.reshape(-1, k))
    xs = xs[:, None]
    if x.device.type == "cuda":
        m, n = xq.shape[0], kernel_q.shape[1]
        pk, pn = -k % 8, -n % 8
        xp = torch.nn.functional.pad(xq, (0, pk, 0, max(0, 17 - m)))
        wt = kernel_q.t()  # [N, K]
        if pk or pn:
            wt = torch.nn.functional.pad(wt, (0, pk, 0, pn))
        acc = torch._int_mm(xp, wt.t())[:m, :n]
    else:
        acc = xq.to(torch.int32) @ kernel_q.to(torch.int32)
    y = acc.float() * xs * kernel_scale.float()
    return y.to(dtype).reshape(lead + (kernel_q.shape[1],))


def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Kernel w [..., in, out] -> {"kernel_q": int8 [..., in, out],
    "kernel_scale": f32 [..., 1, out]}: symmetric per (leading index,
    output channel), amax over the contraction dim / 127."""
    wf = w.float()
    scale = wf.abs().amax(-2, keepdim=True).clamp(min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"kernel_q": q, "kernel_scale": scale}


def _int4_group(fin: int, group: int = INT4_GROUP) -> int:
    """Largest group <= ``group`` for which fin splits into 2*g-aligned
    block-halves packing; 0 = the int8 tier instead."""
    g = group
    while g >= 8 and fin % (2 * g) != 0:
        g //= 2
    return g if g >= 8 else 0


def quantize_int4(w: torch.Tensor, group: int = INT4_GROUP) -> Dict[str, torch.Tensor]:
    """Kernel w [..., in, out] -> {"kernel_q4": int8 [..., in/2, out],
    "kernel_scale4": f32 [..., in/g, out]}: symmetric int4 in [-7, 7] per
    (group of g contraction rows, output channel), scale amax / 7, two
    nibbles per byte in block-halves packing. A contraction dim that no
    group of at least 8 splits (the ViT MLP's 3420) takes the int8 tier:
    the result is then ``quantize_int8(w)``."""
    lead, fin, fout = tuple(w.shape[:-2]), w.shape[-2], w.shape[-1]
    g = _int4_group(fin, group)
    if g == 0:
        return quantize_int8(w)
    wg = w.float().reshape(lead + (fin // g, g, fout))
    scale = wg.abs().amax(-2).clamp(min=1e-8) / 7.0
    q = torch.clamp(torch.round(wg / scale[..., None, :]), -7, 7).to(torch.int8)
    q = q.reshape(lead + (fin, fout))
    lo, hi = q[..., : fin // 2, :], q[..., fin // 2:, :]
    return {"kernel_q4": (lo & 0x0F) | (hi << 4), "kernel_scale4": scale}


def dequant_int4(kernel_q4: torch.Tensor, kernel_scale4: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """-> the kernel [..., in, out] in dtype: each int4 value times its
    group's scale, both cast to dtype first (the JAX package's order)."""
    fin2, fout = kernel_q4.shape[-2], kernel_q4.shape[-1]
    lead = tuple(kernel_q4.shape[:-2])
    n_groups = kernel_scale4.shape[-2]
    q = unpack_int4(kernel_q4).reshape(lead + (n_groups, 2 * fin2 // n_groups, fout))
    w = q.to(dtype) * kernel_scale4[..., None, :].to(dtype)
    return w.reshape(lead + (2 * fin2, fout))


def dequantize_int8(kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """-> the kernel [..., in, out] in dtype (computed in f32)."""
    return (kernel_q.float() * kernel_scale).to(dtype)


def matmul_int4_auto(x: torch.Tensor, kernel_q4: torch.Tensor, kernel_scale4: torch.Tensor,
                     dtype: torch.dtype, a8: bool = False) -> torch.Tensor:
    """x [..., K] (already in dtype) @ int4 weights -> [..., N], routed by
    the JAX package's shape gates (quantization.py:238-256 with
    ops/pallas/int4_matmul.py:91, :268), so a shape takes the same
    arithmetic in both packages:

    - M <= 128 rows with the decode kernel's tiling: K4, ``matmul_int4``
      (on the card straight to its launch, ``int4_decode``, where x is
      bf16 and 16-byte aligned and every operand contiguous on x's card:
      the gate is checked here);
    - a8 with full 256-wide packed k-tiles (the decoder's widths): K6,
      ``matmul_int4_prefill(a8=True)``;
    - everything else: dequantize, then one matmul.

    Each kernel wrapper takes its plain version on a CPU tensor."""
    k, n = 2 * kernel_q4.shape[0], kernel_q4.shape[1]
    g = k // kernel_scale4.shape[0]
    m = x.numel() // k
    if kernel_applicable(m, k, n, g):
        if (x.is_cuda and x.dtype == dtype == torch.bfloat16 and x.is_contiguous()
                and x.data_ptr() % 16 == 0 and kernel_scale4.dtype == torch.float32
                and kernel_q4.is_contiguous() and kernel_scale4.is_contiguous()
                and kernel_q4.device == x.device == kernel_scale4.device):
            return int4_decode(x, kernel_q4, kernel_scale4)
        return matmul_int4(x, kernel_q4, kernel_scale4, out_dtype=dtype)
    if prefill_routable(m, k, n, g, a8):
        return matmul_int4_prefill(x, kernel_q4, kernel_scale4, out_dtype=dtype, a8=True)
    return x @ dequant_int4(kernel_q4, kernel_scale4, dtype)


def quantized_bytes(module: torch.nn.Module) -> int:
    """Bytes of every parameter and buffer (a reporting helper)."""
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))


def quantized_config(cfg, mode: str = "int8", act_quant: str = "none",
                     attn_qk_int8=False, attn_pv_int8=False):
    """ModelConfig -> the same config with int8/int4 weights declared in
    both towers (pair it with ``quantize_model``). act_quant "int8" turns
    on the W8A8 tier everywhere, "prefill" on the ViT and the prefill
    layers only, leaving decode weight-only. attn_qk_int8 extends the tier
    to flash attention's QK^T (per-row dynamic q/k int8, inference only);
    attn_pv_int8 also to its PV product. Each attention flag is a bool
    (both towers) or a scope: "vision", "text" or "both"."""

    def scoped(flag, tower: str, name: str) -> bool:
        if isinstance(flag, str):
            if flag not in ("vision", "text", "both"):
                raise ValueError(f"{name} must be bool or 'vision'/'text'/'both', got {flag!r}")
            return flag in (tower, "both")
        return bool(flag)

    if act_quant in ("int8", "prefill"):
        assert mode in ("int8", "int4"), "act_quant requires quantized weights"
    elif act_quant != "none":
        raise ValueError(f"act_quant must be none/int8/prefill, got {act_quant!r}")
    towers = {}
    for tower in ("vision", "text"):
        qk8 = scoped(attn_qk_int8, tower, "attn_qk_int8")
        pv8 = scoped(attn_pv_int8, tower, "attn_pv_int8")
        if qk8:
            assert act_quant != "none", "attn_qk_int8 rides the act_quant tier"
        if pv8:
            assert qk8, f"attn_pv_int8 rides the attn_qk_int8 tier (tower {tower!r})"
        towers[tower] = (qk8, pv8)
    return dataclasses.replace(
        cfg,
        text=dataclasses.replace(cfg.text, weight_quant=mode, act_quant=act_quant,
                                 attn_qk_int8=towers["text"][0],
                                 attn_pv_int8=towers["text"][1]),
        vision=dataclasses.replace(cfg.vision, weight_quant=mode, act_quant=act_quant,
                                   attn_qk_int8=towers["vision"][0],
                                   attn_pv_int8=towers["vision"][1]),
    )


def _jax_path(module_name: str) -> str:
    """A Linear's module name -> its kernel's JAX parameter path, which
    ``DEFAULT_INCLUDE`` matches: the layer index of the stacked decoder
    layers and ViT blocks goes (``text.layers.3.mlp.up_proj`` ->
    ``text/layers/mlp/up_proj/kernel``)."""
    name = re.sub(r"^(text\.layers|visual\.blocks)\.\d+\.", r"\1.", module_name)
    return name.replace(".", "/") + "/kernel"


def quantize_model(model: torch.nn.Module, mode: str,
                   include: Sequence[str] = DEFAULT_INCLUDE, cfg=None) -> torch.nn.Module:
    """Swap, in place, every Linear whose kernel path matches ``include``
    for a QuantLinear in tier ``mode`` ("int8" or "int4"), quantized on the
    Linear's own device. Each Linear's weight is dropped as soon as its
    QuantLinear exists, so a model on the card is quantized one layer at a
    time. With ``cfg`` (the quantized config its runner will be given) the
    model is then bound to it (``Qwen2_5_VL_GP.set_config``). Returns the
    model."""
    from glimpseprune_torch.models.layers import QuantLinear

    if mode not in ("int8", "int4"):
        raise ValueError(f"quantize_model: mode must be int8 or int4, got {mode!r}")
    targets = [name for name, mod in model.named_modules()
               if isinstance(mod, torch.nn.Linear) and _match(_jax_path(name), include)]
    for name in targets:
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        lin = getattr(parent, attr)
        with torch.no_grad():
            setattr(parent, attr, QuantLinear.from_linear(lin, mode))
        del lin
    return model if cfg is None else model.set_config(cfg)

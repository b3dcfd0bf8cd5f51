"""Decode KV cache, layout [L, B, T, Hkv, D]: in the model dtype, or int8.

Counterpart of glimpseprune_tpu/ops/kv_cache.py (``quantize_kv`` :42,
``alloc_cache`` :58, ``cache_set_prefix`` :68, ``cache_fill_rows`` :80,
``cache_layer`` :96, ``cache_append`` :106, ``cache_t`` :123,
``cache_nbytes`` :127). The int8 tier is the dict

    {"q": int8 [L, B, T, Hkv, D], "s": f32 [L, B, T, Hkv]}

with s = amax(|kv|) / 127 per (layer, row, slot, head). The scale is
constant along the contraction dim of both decode products, so decode
attention applies it to the logits and folds it into the probabilities
(ops/attention.decode_attention) and never dequantizes the cache. The
prefix is quantized once, when the cache is built from the prefill's KV.

JAX arrays are immutable, so the JAX package returns a new cache from every
write; here the writes are in place on the buffers that the decode loop
owns, and the functions return that same cache. ``cache_append`` takes the
slot as an int (prefill callers) or as a 0-d tensor on the cache's device,
which a captured decode step reads at each replay: a Python int would be
baked into the graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

Cache = Union[torch.Tensor, Dict[str, torch.Tensor]]


def is_quantized(cache: Cache) -> bool:
    return isinstance(cache, dict)


def quantize_kv(kv: torch.Tensor,
                amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], f32 scale [...]): symmetric per row,
    amax / 127 (the amax taken in kv's own dtype, where it is exact), round
    half to even. The port's one per-row int8 quantizer: the KV cache's,
    W8A8's and W4A8's activations' (JAX quantization.py:71-74,
    int4_matmul.py:336-339) and K7's q and k rows' (``_quant_rows_i8``
    :232) are the same arithmetic. ``amax`` [...] replaces the rows' own
    (a row-parallel W8A8 product's whole-row amax)."""
    if amax is None:
        amax = kv.abs().amax(-1)
    scale = amax.float().clamp(min=1e-8) / 127.0
    q = torch.clamp(torch.round(kv.float() / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def alloc_cache(shape, dtype, device, quant: str = "none") -> Cache:
    """shape = (L, B, T, Hkv, D); quant "none" (dtype) or "int8"."""
    if quant == "int8":
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    if quant != "none":
        raise ValueError(f"kv cache tier must be none or int8, got {quant!r}")
    return torch.zeros(shape, dtype=dtype, device=device)


def cache_set_prefix(cache: Cache, kv: torch.Tensor, start: int = 0) -> Cache:
    """Write a prefix kv [L, B, R, Hkv, D] into slots [start, start + R)."""
    end = start + kv.shape[2]
    if is_quantized(cache):
        q, s = quantize_kv(kv)
        cache["q"][:, :, start:end] = q
        cache["s"][:, :, start:end] = s
    else:
        cache[:, :, start:end] = kv
    return cache


def cache_fill_rows(cache: Cache, kv: torch.Tensor, b0: int) -> Cache:
    """Write a chunk kv [L, Bc, S, Hkv, D] into rows [b0, b0 + Bc) and slots
    [0, S) (serving assembly: prefill chunks into one decode batch); the
    int8 tier quantizes it here. S must be at most the cache's T."""
    rows, s = slice(b0, b0 + kv.shape[1]), kv.shape[2]
    if is_quantized(cache):
        q, sc = quantize_kv(kv)
        cache["q"][:, rows, :s] = q
        cache["s"][:, rows, :s] = sc
    else:
        cache[:, rows, :s] = kv
    return cache


def cache_layer(cache: Cache, layer: int) -> Cache:
    """[L, B, T, Hkv, D] -> layer's [B, T, Hkv, D] (views)."""
    if is_quantized(cache):
        return {"q": cache["q"][layer], "s": cache["s"][layer]}
    return cache[layer]


def _write_slots(dst: torch.Tensor, src: torch.Tensor, write_idx) -> None:
    """dst [B, T, ...][:, write_idx:write_idx + S_new] = src [B, S_new, ...];
    write_idx an int or a 0-d tensor on dst's device, read there."""
    idx = torch.arange(src.shape[1], device=dst.device) + write_idx
    dst.index_copy_(1, idx, src.to(dst.dtype))


def cache_append(cache: Cache, kv_new: torch.Tensor, layer: int,
                 write_idx: Union[int, torch.Tensor]) -> Cache:
    """Write the new tokens' kv [B, S_new, Hkv, D] into layer at slots
    write_idx.. (an int, or a 0-d tensor on the cache's device, which an
    ``index_copy_`` reads there)."""
    if is_quantized(cache):
        q, s = quantize_kv(kv_new)
        _write_slots(cache["q"][layer], q, write_idx)
        _write_slots(cache["s"][layer], s, write_idx)
    else:
        _write_slots(cache[layer], kv_new, write_idx)
    return cache


def cache_t(cache: Cache) -> int:
    """The number of slots T of a cache [L, B, T, Hkv, D]."""
    return (cache["q"] if is_quantized(cache) else cache).shape[2]


def cache_nbytes(cache: Cache) -> int:
    tensors = cache.values() if is_quantized(cache) else [cache]
    return sum(t.numel() * t.element_size() for t in tensors)

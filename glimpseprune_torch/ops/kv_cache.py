"""Decode KV cache, bf16 (model-dtype) layout [L, B, T, Hkv, D].

Counterpart of the plain-array tier of glimpseprune_tpu/ops/kv_cache.py
(``alloc_cache``, ``cache_set_prefix``, ``cache_layer``, ``cache_append``).
JAX arrays are immutable, so the JAX package returns a new cache from every
write; here the writes are in place (slice assignment) on one buffer that
the decode loop owns, and the functions return that same buffer.
"""

from __future__ import annotations

import torch


def alloc_cache(shape, dtype, device) -> torch.Tensor:
    """shape = (L, B, T, Hkv, D)."""
    return torch.zeros(shape, dtype=dtype, device=device)


def cache_set_prefix(cache: torch.Tensor, kv: torch.Tensor, start: int = 0) -> torch.Tensor:
    """Write a prefix kv [L, B, R, Hkv, D] into slots [start, start + R)."""
    cache[:, :, start:start + kv.shape[2]] = kv
    return cache


def cache_layer(cache: torch.Tensor, layer: int) -> torch.Tensor:
    """[L, B, T, Hkv, D] -> layer's [B, T, Hkv, D] (a view)."""
    return cache[layer]


def cache_append(cache: torch.Tensor, kv_new: torch.Tensor, layer: int,
                 write_idx: int) -> torch.Tensor:
    """Write the new tokens' kv [B, S_new, Hkv, D] into layer at write_idx."""
    cache[layer, :, write_idx:write_idx + kv_new.shape[1]] = kv_new
    return cache

"""Weights for the port: from the JAX params pytree, or random from a seed.

``params_from_jax`` turns the JAX package's Flax params (a nested dict of
arrays) into a state dict for ``Qwen2_5_VL_GP``: Flax ``Dense`` kernels are
[in, out] and become ``Linear.weight`` [out, in]; ``Embed.embedding``
becomes ``Embedding.weight``; the layer-stacked ``[L, ...]`` arrays of the
ViT blocks and decoder layers are split per layer; the fuser's numbered
Flax names (``layers_0``) become ModuleList indices (``layers.0``). A
quantized JAX tree (quantization.quantize_int8 / quantize_int4) carries
``kernel_q``/``kernel_scale`` or ``kernel_q4``/``kernel_scale4`` leaves in
place of ``kernel``; they become the buffers of the port's QuantLinear as
they are (same layout, int8 and f32), stacked ones split per layer. A flax
``LayerNorm``'s ``scale`` becomes ``weight`` (the layernorm glimpse norm).
LoRA leaves (``lora_a`` [L, in, r], ``lora_b`` [L, r, out], the tree of JAX
``training/lora.insert_lora``) become each projection's ``lora_a`` /
``lora_b`` in the same [in, r] / [r, out] layout (a bare adapter tree goes
in through ``training.lora.insert_lora``).

``init_random`` builds full-width random weights directly on a device with
the JAX init's scales: matrices normal / sqrt(fan_in) (lecun normal,
language.py:203-205, vision.py:145-148), embeddings normal / sqrt(hidden),
glimpse embeddings normal(0.02) (gp_model.py:136), biases 0, norms 1.
Under a config with quantized weights both functions return the model with
its Linears swapped for QuantLinears in each tower's tier (``init_random``
quantizes its random weights on the device, one layer at a time).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
from glimpseprune_torch.quantization import DEFAULT_INCLUDE, quantize_model

_STACKED = ("visual.blocks.", "text.layers.")


def _depth(cfg: ModelConfig, stacked: str) -> int:
    return cfg.vision.depth if stacked == "visual.blocks." else cfg.text.num_hidden_layers


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def _leaf(name: str, arr: np.ndarray):
    if name.endswith(".kernel"):
        return name[: -len("kernel")] + "weight", arr.T
    if name.endswith(".embedding"):
        return name[: -len("embedding")] + "weight", arr
    if name.endswith(".scale"):
        return name[: -len("scale")] + "weight", arr
    return name, arr


def params_from_jax(params: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX params pytree (arrays convertible to numpy) -> state dict."""
    state = {}
    for name, arr in _flatten(params).items():
        name = re.sub(r"_(\d+)(?=\.)", r".\1", name)
        stacked = next((p for p in _STACKED if name.startswith(p)), None)
        if stacked is None:
            items = [(name, arr)]
        else:
            rest = name[len(stacked):]
            if arr.shape[0] != _depth(cfg, stacked):
                raise ValueError(f"{name}: {arr.shape[0]} stacked layers, the config "
                                 f"has {_depth(cfg, stacked)}")
            items = [(f"{stacked}{l}.{rest}", arr[l]) for l in range(arr.shape[0])]
        for n, a in items:
            n, a = _leaf(n, a)
            a = np.asarray(a)
            state[n] = torch.tensor(a, dtype=torch.int8 if a.dtype == np.int8 else torch.float32)
    return state


def quantize_towers(model: Qwen2_5_VL_GP, cfg: ModelConfig) -> Qwen2_5_VL_GP:
    """quantize_model on each tower whose config declares quantized weights,
    over that tower's part of DEFAULT_INCLUDE."""
    for tower, prefix in ((cfg.text, "text/"), (cfg.vision, "visual/")):
        if tower.weight_quant != "none":
            quantize_model(model, tower.weight_quant,
                           [p for p in DEFAULT_INCLUDE if p.startswith(prefix)])
    return model


def init_random(cfg: ModelConfig, seed: int, device, dtype=torch.bfloat16) -> Qwen2_5_VL_GP:
    """A Qwen2_5_VL_GP with random weights made on `device` from `seed`."""
    with torch.device("meta"):
        model = Qwen2_5_VL_GP(cfg)
    model = model.to(dtype).to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".lora_a", ".lora_b")):  # the JAX init's zero slots
                p.zero_()
            elif name == "learnable_embeddings":
                p.normal_(0.0, 0.02, generator=gen)
            elif name.endswith("embed_tokens.weight"):
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            elif name.endswith(".bias"):
                p.zero_()
            elif p.ndim == 1:  # norm scales
                p.fill_(1.0)
            else:  # Linear.weight [out, in]
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
    return quantize_towers(model, cfg).requires_grad_(False).eval()


def load_from_jax(params: Mapping, cfg: ModelConfig, device="cuda",
                  dtype=torch.float32) -> Qwen2_5_VL_GP:
    """A Qwen2_5_VL_GP holding the JAX params' weights, on the card unless
    the caller asks for another device."""
    with torch.device("meta"):
        model = quantize_towers(Qwen2_5_VL_GP(cfg), cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True, assign=True)
    return model.to(device=device, dtype=dtype).requires_grad_(False).eval()

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

The LLaVA family (``cfg.model_family == "llava"``, with the CLIP tower's
``clip_cfg``) gives a ``Llava_GP``. Its JAX tree keeps the CLIP blocks per
layer (``layers_{i}``, not stacked), raw ``class_embedding`` /
``position_embedding`` arrays, which keep their names, and a Flax ``Conv``
patch kernel [kh, kw, in, out], which becomes the torch ``Conv2d`` weight
[out, in, kh, kw] (``transpose(3, 2, 0, 1)``, not the 2-D ``.T``).

``init_random`` builds full-width random weights directly on a device with
the JAX init's scales: matrices normal / sqrt(fan_in) (lecun normal,
language.py:203-205, vision.py:145-148; a conv kernel's fan-in is in * kh
* kw), embeddings normal / sqrt(hidden), glimpse embeddings and CLIP's
class and position embeddings normal(0.02) (gp_model.py:136, clip.py:206,
:213), biases 0, norms 1. With ``base``, a state dict of the base weights
(``models/*/convert.py`` from an HF checkpoint), the model takes those
tensors and draws only the rest: the GlimpsePrune modules.
Under a config with quantized weights both functions return the model with
its Linears swapped for QuantLinears in each tower's tier (``init_random``
quantizes its random weights on the device, one layer at a time).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.models.llava.gp_model import CLIPTowerConfig, Llava_GP
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
    if name.endswith(".kernel"):  # Dense [in, out]; Conv [kh, kw, in, out]
        return name[: -len("kernel")] + "weight", (arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                                                   else arr.T)
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


def new_model(cfg: ModelConfig, clip_cfg: Optional[CLIPTowerConfig] = None) -> Qwen2_5_VL_GP:
    """The model class of cfg's family: a Llava_GP over clip_cfg (default
    ``CLIPTowerConfig()``) for "llava", else a Qwen2_5_VL_GP."""
    if cfg.model_family == "llava":
        return Llava_GP(cfg, clip_cfg)
    if clip_cfg is not None:
        raise ValueError(f"clip_cfg is for the llava family, not {cfg.model_family!r}")
    return Qwen2_5_VL_GP(cfg)


def quantize_towers(model: Qwen2_5_VL_GP, cfg: ModelConfig) -> Qwen2_5_VL_GP:
    """quantize_model on each tower whose config declares quantized weights,
    over that tower's part of DEFAULT_INCLUDE (which no CLIP kernel
    matches: LLaVA's tower stays unquantized, as in JAX)."""
    for tower, prefix in ((cfg.text, "text/"), (cfg.vision, "visual/")):
        if tower.weight_quant != "none":
            quantize_model(model, tower.weight_quant,
                           [p for p in DEFAULT_INCLUDE if p.startswith(prefix)])
    return model


def _draw(name: str, p: torch.Tensor, gen: torch.Generator) -> None:
    """Fill p in place by the JAX init's rule for the parameter ``name``."""
    if name.endswith((".lora_a", ".lora_b")):  # the JAX init's zero slots
        p.zero_()
    elif name in ("learnable_embeddings", "visual.class_embedding",
                  "visual.position_embedding", "clip_text.position_embedding"):
        p.normal_(0.0, 0.02, generator=gen)
    elif name.endswith(("embed_tokens.weight", "token_embedding.weight")):
        p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
    elif name.endswith(".bias"):
        p.zero_()
    elif p.ndim == 1:  # norm scales
        p.fill_(1.0)
    else:  # Linear.weight [out, in], Conv2d.weight [out, in, kh, kw]
        p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)


def init_random(cfg: ModelConfig, seed: int, device, dtype=torch.bfloat16,
                clip_cfg: Optional[CLIPTowerConfig] = None,
                base: Optional[Mapping[str, torch.Tensor]] = None) -> Qwen2_5_VL_GP:
    """The model of cfg's family with random weights made on `device` from
    `seed`. ``base``: weights the model takes as they are (cast to dtype
    on device, without a copy where they already are), a key the model
    lacks raising; only the parameters base lacks are drawn."""
    with torch.device("meta"):
        model = new_model(cfg, clip_cfg).to(dtype)
    base = dict(base or {})
    slots = model.state_dict()
    unknown = sorted(set(base) - set(slots))
    if unknown:
        raise ValueError(f"the base weights hold {len(unknown)} keys the model lacks, "
                         f"such as {unknown[:3]}")
    model.load_state_dict({k: v.to(device=device, dtype=slots[k].dtype)
                           for k, v in base.items()}, strict=False, assign=True)
    for mod in model.modules():
        for leaf, p in mod._parameters.items():
            if p is not None and p.is_meta:
                mod._parameters[leaf] = nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device=device), p.requires_grad)
    model.to(device=device, dtype=dtype)  # the fp32 LayerNorms' rule, nothing else moves
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name not in base:
                _draw(name, p, gen)
    return quantize_towers(model, cfg).requires_grad_(False).eval()


def load_from_jax(params: Mapping, cfg: ModelConfig, device="cuda", dtype=torch.float32,
                  clip_cfg: Optional[CLIPTowerConfig] = None) -> Qwen2_5_VL_GP:
    """The model of cfg's family holding the JAX params' weights, on the
    card unless the caller asks for another device."""
    with torch.device("meta"):
        model = quantize_towers(new_model(cfg, clip_cfg), cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True, assign=True)
    return model.to(device=device, dtype=dtype).requires_grad_(False).eval()

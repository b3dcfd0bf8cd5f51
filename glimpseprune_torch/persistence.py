"""New-module persistence: the separate-artifact checkpoint contract.

Counterpart of the new-module part of glimpseprune_tpu/persistence.py
(``save_new_modules`` / ``load_new_modules`` :45-67). Only the small
GlimpsePrune modules are trained, so only they are saved, beside the
model's ``config.json``; the base model comes from its own checkpoint.
The file is the reference release's ``new_modules_gp.pt`` layout (reference
model_gp.py:941-952): ``{"attn_fuser": fuser state dict,
"learnable_embeddings": tensor, "le_proj": {"weight", "bias"},
"le_norm": {"weight"}}``, which the JAX package reads through
``import_torch_new_modules`` (persistence.py:80).

The GlimpsePrune+ adapters (``save_lora`` / ``load_lora``, JAX :28-42) are
saved apart, as ``lora_adapter.pt``: the adapter tree of training/lora.py
({kernel path: {"a", "b"}}, fp32 CPU tensors) in torch's format; the port
does not read the JAX package's msgpack.

Full-model checkpoints (``save_full_params`` / ``load_full_params``, JAX
:156-171, which uses orbax) are the model's whole state dict in torch's
format, ``full_params.pt``, beside ``config.json`` (and, for a LLaVA
model, ``clip_config.json``): every tensor in its own dtype and layout,
the quantized tiers' int8 / int4 buffers and fp32 scales included, so a
model converted or quantized once is not converted again at each start.

A model sharded over a mesh's model axis (parallel/mesh.py) holds a rank's
slices of its towers' weights: ``save_full_params`` refuses it (its state
dict is one rank's, not the config's model). The GlimpsePrune modules are
never sharded, so ``save_new_modules`` writes them whole from any rank,
and ``training.lora.lora_tree`` gathers the adapters' parts, so
``save_lora(lora_tree(model), ...)`` writes the whole adapters.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from glimpseprune_torch.config import ModelConfig

NEW_MODULES_FILE = "new_modules_gp.pt"
LORA_FILE = "lora_adapter.pt"
FULL_PARAMS_FILE = "full_params.pt"
CLIP_CONFIG_FILE = "clip_config.json"


def save_lora(lora: Mapping, directory: str) -> str:
    """Write an adapter tree (``make_lora_params`` / ``lora_tree``) as
    ``lora_adapter.pt`` into directory."""
    state = {path: {k: torch.as_tensor(v).detach().float().cpu() for k, v in ab.items()}
             for path, ab in lora.items()}
    os.makedirs(directory, exist_ok=True)
    torch.save(state, os.path.join(directory, LORA_FILE))
    return directory


def load_lora(directory: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """The adapter tree saved in directory (``insert_lora`` puts it into a
    model)."""
    return torch.load(os.path.join(directory, LORA_FILE), map_location="cpu",
                      weights_only=True)


def save_new_modules(model: nn.Module, cfg: ModelConfig, directory: str) -> str:
    """Write the model's GlimpsePrune modules (fp32, on the CPU) as
    ``new_modules_gp.pt``, and ``config.json``, into directory."""

    def sd(module):
        return {k: v.detach().float().cpu() for k, v in module.state_dict().items()}

    modules = [model.attn_fuser] + ([model.le_proj, model.le_norm] if model.cfg.gp.has_le
                                    else [])
    if any(getattr(m, "tp", None) is not None for mod in modules for m in mod.modules()):
        raise ValueError("save_new_modules: a GlimpsePrune module is sharded; only the "
                         "towers' layers of parallel/mesh.py's table may be")
    state = {"attn_fuser": sd(model.attn_fuser)}
    if model.cfg.gp.has_le:
        state["learnable_embeddings"] = model.learnable_embeddings.detach().float().cpu()
        state["le_proj"] = sd(model.le_proj)
        state["le_norm"] = sd(model.le_norm)
    os.makedirs(directory, exist_ok=True)
    torch.save(state, os.path.join(directory, NEW_MODULES_FILE))
    cfg.save(directory)
    return directory


@torch.no_grad()
def load_new_modules(model: nn.Module, directory: str) -> Tuple[nn.Module, ModelConfig]:
    """Copy the saved GlimpsePrune modules into model, in place, keeping
    each parameter's device and dtype -> (model, the saved config)."""
    cfg = ModelConfig.load(directory)
    state = torch.load(os.path.join(directory, NEW_MODULES_FILE), map_location="cpu",
                       weights_only=True)
    model.attn_fuser.load_state_dict(state["attn_fuser"], strict=True)
    if model.cfg.gp.has_le:
        model.learnable_embeddings.copy_(state["learnable_embeddings"])
        model.le_proj.load_state_dict(state["le_proj"], strict=True)
        model.le_norm.load_state_dict(state["le_norm"], strict=True)
    return model, cfg


def save_full_params(model: nn.Module, cfg: ModelConfig, directory: str) -> str:
    """Write model's whole state dict as ``full_params.pt``, and cfg (the
    config the model is bound to) as ``config.json``, into directory. A
    model sharded over a model axis of more than one rank is refused: its
    state dict holds this rank's slices."""
    mesh = getattr(model, "mesh", None)
    if mesh is not None and mesh.shape["model"] > 1:
        raise ValueError("save_full_params: the model is sharded over a model axis of "
                         f"{mesh.shape['model']} ranks; its state dict holds one rank's "
                         "slices. Save the unsharded model")
    os.makedirs(directory, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(directory, FULL_PARAMS_FILE))
    cfg.save(directory)
    clip_cfg = getattr(model, "clip_cfg", None)
    if clip_cfg is not None:
        with open(os.path.join(directory, CLIP_CONFIG_FILE), "w") as f:
            json.dump(dataclasses.asdict(clip_cfg), f, indent=2)
    return directory


def load_full_params(directory: str, device="cuda") -> Tuple[nn.Module, ModelConfig]:
    """(the model saved by ``save_full_params`` on device, its config). The
    model is built on the meta device, in its config's weight tiers, and
    takes the loaded tensors as they are (``assign``), so no weight is
    allocated twice; the file is memory-mapped, not read whole."""
    from glimpseprune_torch.convert import new_model, quantize_towers
    from glimpseprune_torch.models.llava.gp_model import CLIPTowerConfig

    cfg = ModelConfig.load(directory)
    clip_cfg = None
    clip_path = os.path.join(directory, CLIP_CONFIG_FILE)
    if os.path.exists(clip_path):
        with open(clip_path) as f:
            clip_cfg = CLIPTowerConfig(**json.load(f))
    with torch.device("meta"):
        model = quantize_towers(new_model(cfg, clip_cfg), cfg)
    state = torch.load(os.path.join(directory, FULL_PARAMS_FILE), map_location=device,
                       weights_only=True, mmap=True)
    model.load_state_dict(state, strict=True, assign=True)
    return model.requires_grad_(False).eval(), cfg

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
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
from torch import nn

from glimpseprune_torch.config import ModelConfig

NEW_MODULES_FILE = "new_modules_gp.pt"


def save_new_modules(model: nn.Module, cfg: ModelConfig, directory: str) -> str:
    """Write the model's GlimpsePrune modules (fp32, on the CPU) as
    ``new_modules_gp.pt``, and ``config.json``, into directory."""

    def sd(module):
        return {k: v.detach().float().cpu() for k, v in module.state_dict().items()}

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

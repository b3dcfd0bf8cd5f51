"""LoRA adapters over the frozen model: the GlimpsePrune+ trainables.

Counterpart of glimpseprune_tpu/training/lora.py (``make_lora_params`` :28,
``apply_lora`` :67, ``insert_lora`` :93, ``lora_param_count`` :124). The
adapter tree is the JAX package's: {kernel path: {"a": [L, in, r], "b": [L,
r, out]}}, keyed by the JAX kernel paths that ``DEFAULT_TARGETS`` matches
(``text/layers/self_attn/q_proj/kernel``, ...), fp32. ``make_lora_params``
draws A from ``np.random.default_rng(seed)`` in the JAX package's order
(the sorted kernel paths; an int8 base's ``kernel_q`` paths lose their
``_q``; an int4 base's ``kernel_q4`` match nothing), so from one seed both
packages hold the same adapters.

``insert_lora`` puts the adapters into the model's projections in place
(models/layers.py: y += (x @ a) @ b inside each layer, no merged kernel
copy) and binds the model to ``text.lora_rank = r``; the policy is the
model, the reference policy is the same model under ``lora_disabled``.
``apply_lora`` returns a copy of an unquantized model with W + A B merged
into its weights, the reference for the in-layer product.

On a model sharded by ``shard_params`` (parallel/mesh.py) the tree is the
whole model's in every function: ``make_lora_params`` draws the whole
adapters, ``insert_lora`` and ``apply_lora`` take each sharded layer's
part (``lora_b``'s columns of a column-parallel layer, ``lora_a``'s rows
of a row-parallel one), and ``lora_tree`` gathers the parts back, so
every rank returns (and ``persistence.save_lora`` writes) what one
process would; it is collective over the model axis there.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from glimpseprune_torch.models.layers import (
    QuantLinear,
    adapted_modules,
    attach_lora,
    lora_disabled,
)
from glimpseprune_torch.quantization import _jax_path

DEFAULT_TARGETS = (r"text/layers/(self_attn/(q_proj|k_proj|v_proj|o_proj)|"
                   r"mlp/(gate_proj|up_proj|down_proj))/kernel(_q)?")

__all__ = ["DEFAULT_TARGETS", "make_lora_params", "apply_lora", "insert_lora",
           "lora_param_count", "lora_parameters", "lora_tree", "lora_disabled",
           "remove_lora"]


def _kernel_path(name: str, mod: nn.Module) -> Optional[str]:
    """The JAX path of a projection's kernel leaf (``kernel``, ``kernel_q``
    or ``kernel_q4`` by its tier), or None for another module."""
    if isinstance(mod, nn.Linear):
        return _jax_path(name)
    if isinstance(mod, QuantLinear):
        return _jax_path(name) + ("_q" if mod.mode == "int8" else "_q4")
    return None


def _targets(model: nn.Module, targets: str) -> Dict[str, tuple]:
    """{kernel path without its tier suffix: (L, in, out)} of the
    projections whose kernel path matches ``targets``, in the JAX package's
    leaf order (``DEFAULT_TARGETS`` takes int8 bases, not int4 ones, as in
    JAX; a pattern admitting ``kernel_q4`` adapts an int4 base)."""
    pattern = re.compile(targets)
    found = {}
    for name, mod in model.named_modules():
        path = _kernel_path(name, mod)
        if path is None or not pattern.fullmatch(path):
            continue
        key = re.sub(r"_q4?$", "", path)
        layered = name.startswith("text.layers.")
        fin, fout = _whole_features(mod)
        shape = (model.cfg.text.num_hidden_layers, fin, fout) if layered else (fin, fout)
        found.setdefault(key, shape)
    return dict(sorted(found.items()))


def make_lora_params(model: nn.Module, rank: int = 16, targets: str = DEFAULT_TARGETS,
                     seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """The adapter tree of ``model`` (CPU fp32 tensors): A ~ N(0, 1/r) from
    ``np.random.default_rng(seed)``, B = 0 (JAX :28-64)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in _targets(model, targets).items():
        a_shape, b_shape = shape[:-1] + (rank,), shape[:-2] + (rank, shape[-1])
        out[path] = {"a": torch.tensor(rng.normal(0, 1.0 / max(rank, 1), a_shape),
                                       dtype=torch.float32),
                     "b": torch.zeros(b_shape, dtype=torch.float32)}
    return out


def _whole_features(mod: nn.Module):
    """(in, out) of a projection's whole layer, sharded or not."""
    world = 1 if mod.tp is None else mod.tp.world
    return (mod.in_features * (world if mod.tp_mode == "row" else 1),
            mod.out_features * (world if mod.tp_mode == "column" else 1))


def _part(mod: nn.Module, key: str, t: torch.Tensor) -> torch.Tensor:
    """The part of a whole adapter leaf ``t`` (``"a"`` [in, r] or ``"b"``
    [r, out]) that mod holds: all of it unless mod is sharded along it."""
    if (key, mod.tp_mode) in (("a", "row"), ("b", "column")):
        from glimpseprune_torch.parallel.mesh import local_part

        return local_part(mod, t, 0 if key == "a" else 1)
    return t


def _whole(mod: nn.Module, key: str, t: torch.Tensor) -> torch.Tensor:
    """``_part``'s inverse: the whole adapter leaf from every rank's part."""
    if (key, mod.tp_mode) in (("a", "row"), ("b", "column")):
        from glimpseprune_torch.parallel.mesh import whole_part

        return whole_part(mod, t, 0 if key == "a" else 1)
    return t


def _modules_of(model: nn.Module, path: str):
    """[(layer index or None, module)] that a kernel path names."""
    name = path.removesuffix("/kernel").replace("/", ".")
    if name.startswith("text.layers."):
        rest = name[len("text.layers."):]
        return [(l, layer.get_submodule(rest)) for l, layer in enumerate(model.text.layers)]
    return [(None, model.get_submodule(name))]


def _tensor(x) -> torch.Tensor:
    """An adapter leaf (a torch tensor, or an array such as the JAX
    package's) as a torch tensor."""
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _with_rank(cfg, rank: int):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, lora_rank=rank))


@torch.no_grad()
def insert_lora(model: nn.Module, lora: Optional[Mapping], scale: float = 1.0,
                cfg=None) -> nn.Module:
    """Put the adapters of ``lora`` into model's projections, in place (JAX
    :93-121): a becomes ``lora_a``, b * scale ``lora_b``, fp32 on the
    projection's device, frozen (``lora_parameters`` makes them trainable).
    Only the projections that the tree's paths name are adapted; the others
    keep what they had (W8A8 stays on where they had no adapter). Adapters
    already there are overwritten in place, so that a captured decode step
    that reads them stays valid. The model is then bound to ``cfg``
    (default: its own config with ``text.lora_rank`` = r)."""
    if not lora:
        return model
    rank = next(iter(lora.values()))["a"].shape[-1]
    for path, ab in lora.items():
        a, b = _tensor(ab["a"]), _tensor(ab["b"])
        for l, mod in _modules_of(model, path):
            if mod.lora_a is None:
                attach_lora([mod], rank)
            elif mod.lora_a.shape[1] != rank:
                raise ValueError(f"{path}: the model carries a rank-{mod.lora_a.shape[1]} "
                                 f"adapter there, not rank {rank}")
            mod.lora_a.copy_(_part(mod, "a", a if l is None else a[l]))
            mod.lora_b.copy_(_part(mod, "b", (b if l is None else b[l]).float() * scale))
    return model.set_config(cfg if cfg is not None else _with_rank(model.cfg, rank))


def remove_lora(model: nn.Module) -> nn.Module:
    """Drop every adapter and bind the model to ``text.lora_rank = 0``."""
    for _, mod in list(adapted_modules(model)):
        mod.lora_a = mod.lora_b = None
    return model.set_config(_with_rank(model.cfg, 0))


@torch.no_grad()
def apply_lora(model: nn.Module, lora: Optional[Mapping], scale: float = 1.0) -> nn.Module:
    """A copy of model (unquantized, without adapters) whose adapted
    weights hold W + scale * A B, summed in fp32 and cast back (JAX
    :67-90); model itself is not changed."""
    if not lora:
        return model
    merged = copy.deepcopy(model)
    for path, ab in lora.items():
        a, b = _tensor(ab["a"]), _tensor(ab["b"])
        for l, mod in _modules_of(merged, path):
            if not isinstance(mod, nn.Linear):
                raise ValueError(f"{path}: apply_lora merges into unquantized weights only")
            al, bl = (a, b) if l is None else (a[l], b[l])
            al, bl = _part(mod, "a", al), _part(mod, "b", bl)  # a shard's own
            delta = (al.float() @ bl.float()) * scale  # [in, out]
            w = mod.weight
            w.copy_((w.float() + delta.t().to(w.device)).to(w.dtype))
    return merged


def lora_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """{name: parameter} of model's adapters (``...q_proj.lora_a``), set
    trainable."""
    out = {}
    for name, mod in adapted_modules(model):
        for key in ("lora_a", "lora_b"):
            p = getattr(mod, key)
            p.requires_grad_(True)
            out[f"{name}.{key}"] = p
    return out


def lora_param_count(lora: Mapping) -> int:
    """The number of adapter values in a tree (JAX :124)."""
    return sum(int(np.prod(np.shape(x))) for ab in lora.values() for x in ab.values())


def lora_tree(model: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """model's adapters as the JAX-keyed tree (CPU fp32, layers stacked);
    the whole adapters on a sharded model (collective there)."""
    tree: Dict[str, Dict[str, list]] = {}
    for name, mod in adapted_modules(model):
        path = _jax_path(re.sub(r"^text\.layers\.\d+\.", "text.layers.", name))
        ent = tree.setdefault(path, {"a": [], "b": []})
        ent["a"].append(_whole(mod, "a", mod.lora_a.detach()).float().cpu())
        ent["b"].append(_whole(mod, "b", mod.lora_b.detach()).float().cpu())
    return {p: {k: (torch.stack(v) if p.startswith("text/layers/") else v[0])
                for k, v in ab.items()} for p, ab in sorted(tree.items())}

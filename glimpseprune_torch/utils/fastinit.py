"""Fast random weights for the profilers: the JAX package's law, drawn on
the host in JAX's order, or on the card straight into the port's buffers.

Counterpart of glimpseprune_tpu/utils/fastinit.py (``_inv_cdf_table`` :51,
``_draw_q`` :65, ``device_random_params`` :70, ``fast_random_params`` :172).
The law (JAX :14-33): normal(0, fan_in ** -0.5) for every kernel and
embedding of the JAX layout (fan_in = the leaf's shape[-2]: a Dense
kernel's input width, an embedding's vocabulary), zeros for biases and
LoRA slots, ones for norm scales, normal(0, 0.02) for the glimpse
embeddings. A quantized kernel is drawn directly in its tier: int8 values
of round(N(0, qmax / 4)) clipped to +-qmax, with the constant scale
``fan_in ** -0.5 * 4 / qmax`` that restores the std (qmax 127 for int8, 7
for each nibble of int4's block-halves packing); no float copy of it is
made.

- ``fast_random_params(cfg, seed)`` returns the JAX-layout numpy tree (nested
  dicts, keys in JAX's sorted order, arrays float32 / int8), drawn by numpy's
  PCG64 from ``seed`` leaf by leaf in JAX's order, so the same seed gives the
  bytes of JAX's ``fast_random_params``; ``convert.params_from_jax`` (or
  ``load_from_jax``) turns it into the port's weights. The tree's shapes
  come from the port's model built on the meta device, mapped back to the
  JAX layout (``jax_param_shapes``), so no JAX is needed.
- ``device_random_params(cfg, seed, device)`` draws the same law on
  ``device`` with an explicit ``torch.Generator`` into the model's own
  tensors, built on the meta device and allocated once in their final dtype
  and layout: a quantized linear is drawn in bounded chunks straight into
  its int8 buffer (no bf16 or fp32 copy of the weights), so the peak during
  the draw is the finished weights plus one chunk.

Both are for profiling and benches, where realistic magnitudes matter and
the exact init does not.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from glimpseprune_torch.config import ModelConfig

# absmax-to-sigma ratio of the direct quantized draw (JAX :45): a kernel
# column of 10^3-10^4 normal draws has amax ~ 3.5-4 sigma
_AMAX_SIGMAS = 4.0
# elements drawn at once on the device: bounds the fp32 temporaries
_CHUNK = 1 << 24
_QUANT = ("kernel_q", "kernel_scale", "kernel_q4", "kernel_scale4")
_STACKED = re.compile(r"^(visual\.blocks|text\.layers)\.(\d+)\.(.*)$")


@lru_cache(maxsize=None)
def _inv_cdf_table(sigma_q: float, qmax: int) -> np.ndarray:
    """65536-entry int8 quantile table of round(N(0, sigma_q)) clipped to
    +-qmax: uniform uint16 indices drawn through it give an exactly
    discretized normal."""
    from statistics import NormalDist

    nd = NormalDist()
    n = 1 << 16
    vals = np.asarray([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(vals * sigma_q), -qmax, qmax).astype(np.int8)


def _draw_q(rng: np.random.Generator, shape, qmax: int) -> np.ndarray:
    table = _inv_cdf_table(qmax / _AMAX_SIGMAS, qmax)
    return table[rng.integers(0, 1 << 16, size=shape, dtype=np.uint16)]


def _meta_model(cfg: ModelConfig):
    from glimpseprune_torch.convert import new_model, quantize_towers

    if cfg.model_family != "qwen2_5_vl":
        raise ValueError(f"fastinit draws qwen2_5_vl models, not {cfg.model_family!r}")
    with torch.device("meta"):
        return quantize_towers(new_model(cfg), cfg)


def _jax_leaf(mod: nn.Module, leaf: str, shape: Tuple[int, ...]):
    """A tensor's leaf name and shape in the JAX layout (the inverse of
    ``convert._leaf``)."""
    from glimpseprune_torch.models.layers import LayerNorm

    if leaf != "weight":
        return leaf, shape
    if isinstance(mod, nn.Embedding):
        return "embedding", shape
    if isinstance(mod, LayerNorm):
        return "scale", shape
    if len(shape) == 2:  # Linear [out, in] -> Dense kernel [in, out]
        return "kernel", shape[::-1]
    return leaf, shape  # RMSNorm


def _jax_path(module_name: str):
    """``attn_fuser.layers.0.attn`` -> (attn_fuser, layers_0, attn)."""
    return tuple(re.sub(r"\.(\d+)(?=\.|$)", r"_\1", module_name).split(".")) \
        if module_name else ()


def _leaves(model: nn.Module) -> Iterator[Tuple[str, tuple, tuple, bool]]:
    """(port name, JAX path, JAX leaf shape, whether the tensor stands for
    its leaf) per tensor of the state dict. The layer index of a stacked
    tower leaves the JAX path and the depth leads the JAX shape; layer 0
    stands for the stack."""
    mods = dict(model.named_modules())
    depth = {"visual.blocks": len(model.visual.blocks), "text.layers": len(model.text.layers)}
    for name, t in model.state_dict().items():
        mod_name, _, leaf = name.rpartition(".")
        jleaf, jshape = _jax_leaf(mods[mod_name], leaf, tuple(t.shape))
        m = _STACKED.match(mod_name + ".")
        if m:
            path = tuple(m.group(1).split(".")) + _jax_path(m.group(3).rstrip("."))
            yield name, path + (jleaf,), (depth[m.group(1)],) + jshape, m.group(2) == "0"
        else:
            yield name, _jax_path(mod_name) + (jleaf,), jshape, True


def jax_param_shapes(cfg: ModelConfig) -> Dict:
    """The JAX package's params tree for cfg as nested dicts of (shape,
    dtype) leaves, keys sorted at every level as JAX orders a tree."""
    tree: Dict = {}
    model = _meta_model(cfg)
    sd = model.state_dict()
    for name, path, jshape, first in _leaves(model):
        if not first:
            continue
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        dt = sd[name].dtype
        node[path[-1]] = (jshape, np.int8 if dt == torch.int8 else np.float32)

    def ordered(node):
        return {k: ordered(node[k]) if isinstance(node[k], dict) else node[k]
                for k in sorted(node)}

    return ordered(tree)


def _host_leaf(rng: np.random.Generator, name: str, shape) -> np.ndarray:
    """JAX :190-214's rule for one unquantized leaf."""
    if name == "bias" or not shape:
        return np.zeros(shape, np.float32)
    if name in ("scale", "weight") and len(shape) <= 2:
        return np.ones(shape, np.float32)
    if name in ("lora_a", "lora_b"):
        return np.zeros(shape, np.float32)
    if name == "learnable_embeddings":
        return rng.standard_normal(shape, dtype=np.float32) * 0.02
    if len(shape) >= 2:
        return rng.standard_normal(shape, dtype=np.float32) * (float(shape[-2]) ** -0.5)
    return np.zeros(shape, np.float32)


def fast_random_params(cfg: ModelConfig, seed: int = 0) -> Dict:
    """Host-drawn random params in the JAX layout for cfg (fp or quantized
    weights), byte-equal to JAX's ``fast_random_params`` at the same seed."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        if "kernel_q" in node:
            (qshape, _), (sshape, _) = node["kernel_q"], node["kernel_scale"]
            out["kernel_q"] = _draw_q(rng, qshape, 127)
            out["kernel_scale"] = np.full(
                sshape, float(qshape[-2]) ** -0.5 * _AMAX_SIGMAS / 127.0, np.float32)
        if "kernel_q4" in node:
            (qshape, _), (sshape, _) = node["kernel_q4"], node["kernel_scale4"]
            fan_in = 2 * qshape[-2]  # block-halves packing
            q = _draw_q(rng, qshape[:-2] + (fan_in, qshape[-1]), 7)
            lo, hi = q[..., : fan_in // 2, :], q[..., fan_in // 2:, :]
            out["kernel_q4"] = ((lo & 0x0F) | (hi << 4)).astype(np.int8)
            out["kernel_scale4"] = np.full(
                sshape, float(fan_in) ** -0.5 * _AMAX_SIGMAS / 7.0, np.float32)
        for name, sub in node.items():
            if name in _QUANT:
                continue
            out[name] = walk(sub) if isinstance(sub, dict) else _host_leaf(rng, name, sub[0])
        return out

    return walk(jax_param_shapes(cfg))


def _draw_q_device(out: torch.Tensor, qmax: int, gen: torch.Generator,
                   packed: bool = False) -> None:
    """Fill int8 ``out`` (any memory order) with round(N(0, qmax / 4))
    clipped to +-qmax, or with two such int4 draws packed a byte (lo |
    hi << 4), _CHUNK elements at a time along its first dim."""
    rows = max(1, _CHUNK // max(1, out[0].numel()))
    for i in range(0, out.shape[0], rows):
        dst = out[i:i + rows]

        def one():
            z = torch.randn(dst.shape, generator=gen, device=out.device, dtype=torch.float32)
            return z.mul_(qmax / _AMAX_SIGMAS).round_().clamp_(-qmax, qmax).to(torch.int8)

        dst.copy_(one().bitwise_and_(0x0F).bitwise_or_(one().bitwise_left_shift_(4))
                  if packed else one())


def _fill(jleaf: str, jshape, t: torch.Tensor, gen: torch.Generator) -> None:
    """Fill the port tensor t, the unquantized JAX leaf ``jleaf`` of JAX
    shape ``jshape`` (a stack's depth dropped), by the host law's rule."""
    if jleaf in ("bias", "lora_a", "lora_b") or not jshape:
        t.zero_()
    elif jleaf in ("scale", "weight") and len(jshape) <= 2:
        t.fill_(1.0)
    elif jleaf == "learnable_embeddings":
        t.normal_(0.0, 0.02, generator=gen)
    elif len(jshape) >= 2:
        t.normal_(0.0, float(jshape[-2]) ** -0.5, generator=gen)
    else:
        t.zero_()


def device_random_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                         dtype=torch.bfloat16) -> nn.Module:
    """The model of cfg with random weights drawn on ``device`` by the host
    law, each tensor allocated once in its final dtype and memory order
    (int8 quantized buffers, fp32 scales, ``dtype`` elsewhere); quantized
    kernels are drawn directly as int8. Returns the model, frozen and in
    eval mode, not bound to a config (``set_config``)."""
    model = _meta_model(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    mods = dict(model.named_modules())
    with torch.no_grad():
        for name, path, jshape, _ in list(_leaves(model)):
            mod_name, _, leaf = name.rpartition(".")
            mod = mods[mod_name]
            slot = mod._parameters if leaf in mod._parameters else mod._buffers
            meta = slot[leaf]
            dt = (meta.dtype if meta.dtype == torch.int8
                  else torch.float32 if leaf in ("kernel_scale", "kernel_scale4") else dtype)
            t = torch.empty_strided(meta.shape, meta.stride(), dtype=dt, device=device)
            jleaf = path[-1]
            if jleaf in ("kernel_q", "kernel_q4"):
                _draw_q_device(t, 127 if jleaf == "kernel_q" else 7, gen,
                               packed=jleaf == "kernel_q4")
            elif jleaf == "kernel_scale":
                t.fill_(float(mod.kernel_q.shape[0]) ** -0.5 * _AMAX_SIGMAS / 127.0)
            elif jleaf == "kernel_scale4":
                t.fill_(float(2 * mod.kernel_q4.shape[0]) ** -0.5 * _AMAX_SIGMAS / 7.0)
            else:
                _fill(jleaf, jshape[1:] if _STACKED.match(mod_name + ".") else jshape, t, gen)
            slot[leaf] = nn.Parameter(t, requires_grad=False) if slot is mod._parameters else t
    return model.requires_grad_(False).eval()

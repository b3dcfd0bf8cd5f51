"""The 2-D (data, model) mesh over ``torch.distributed``: tensor
parallelism (TP) of the weights over the ``model`` axis, the batch split
over the ``data`` axis.

Counterpart of glimpseprune_tpu/parallel/mesh.py:24-132 (``make_mesh``,
``param_sharding_rules``, ``shard_params``, ``shard_batch``). In JAX the
sharding is annotation only: the params get NamedShardings from path
rules and GSPMD inserts the collectives. PyTorch has no GSPMD, so
``shard_params`` keeps each rank's slice of the weights and marks each
sharded module with its role, and the modules run the Megatron-style
collectives themselves (models/layers.py, language.py, vision.py), with
the autograd pair ``copy_to_model`` / ``reduce_from_model`` of
parallel/sequence.py:

- column-parallel (q/k/v, gate/up, the ViT's qkv and MLP's gate/up,
  ``lm_head``): the output columns are split; the input is
  replicated. ``copy_to_model`` marks the input: identity forward,
  all-reduce of the gradient backward (each rank's columns contribute to
  the whole input gradient).
- row-parallel (o_proj, down_proj, the ViT's proj and down): the
  contraction rows are split; the partial sums meet in
  ``reduce_from_model`` (all-reduce forward, identity backward) and the
  bias is added once, after it. W8A8 takes its activation scale from the
  whole row (an all-reduce MAX) and all-reduces the int32 sums before the
  rescale (quantization.matmul_w8a8), so it is bit-equal to one rank's.
- vocab-parallel: ``embed_tokens`` (a masked lookup of the local vocab
  rows, then an all-reduce) and the head (``lm_head``, or the tied
  embedding), whose logits are all-gathered along the vocab
  (parallel/sequence.py ``gather_seq``: all-gather forward, this rank's
  block backward, as for any sharded tensor that replicated compute
  reads).

Attention runs on each rank's heads: q and kv heads split contiguously,
so q head h still reads kv head h // g; the decode cache holds the local
kv heads; the glimpse harvest ([B, S, Hq]) is all-gathered along the heads
before the fuser, which runs replicated with the other GlimpsePrune
modules. The ViT's qkv output is laid out [3, heads, D], so its shard is
taken per (3, heads / tp, D), not as a contiguous run of columns.

``shard_params`` runs from one table, ``_TP_LAYERS``: a Linear's JAX
path -> its unit and its mode. JAX drops a rule's axis where the
dimension does not divide the axis size (mesh.py:90-102). Here a unit is
sharded whole or not at all: attention where both head counts divide, an
MLP where its intermediate size divides, the vocab where it divides.
``param_sharding_rules`` keeps JAX's own regex table, against which the
tests hold ``shard_params``. The quantized int8 scales
[1, out] of a column-parallel layer are sliced with its columns (JAX
replicates them: GSPMD slices them where they meet the sharded product).
The ViT's merger stays whole on every rank, where JAX's rules shard its
fc1 columns and fc2 rows: it is the one product of the (q8) prefill that
no tier quantizes, so a row-parallel fc2 would round its bf16 partial
sums apart from one process's, and on the card that moved a keep
decision at a near-tie (the keep sets of one process and of the mesh
differed). Whole, the (q8) prefill on the mesh is the same arithmetic as
one process's; the merger holds ~0.5% of the 7B's weights.

The (q4) tier: a column-parallel layer's ``kernel_q4`` [K/2, N] and
``kernel_scale4`` [K/g, N] are cut by columns. The block-halves packing
pairs contraction row k with row k + K/2 of the whole dimension, so a
row-parallel layer's packed rows are not a rank's rows: ``_int4_rows``
unpacks, keeps rows [r K / tp, (r + 1) K / tp) and packs them again as the
block-halves of the local K / tp, with the scale rows of the same groups.
Unit-or-nothing covers it: a unit stays whole where one of its int4
row-parallel layers would hold a local K that is no multiple of 2 g
(``_int4_row_fits``). The products route on the whole layer's shape
(quantization.matmul_int4_auto). A ViT unit with int4 layers stays whole
too, as the merger does: the ViT's int4 products (K = 1280, whose packed
rows tile by 128, not 256) route to no kernel but the dequantized bf16
GEMM, which a shard runs at other GEMM shapes than one process, and the
ViT's int8 attention and W8A8 round those differences into other int8
values; on the card that moved the (q4) keep sets (first logits 4.6e-2
apart, mask logits 7.2e-2). Whole, the (q4) mesh's ViT is one process's
arithmetic, and its decoder's K4 / K6 products are bit-equal or round
once from fp32.

LLaVA: its decoder is sharded by the same rows; the CLIP towers and the
projector match no rule and stay whole on every rank, as in JAX.

LoRA: an adapter is cut with its layer (models/layers.py), whichever of
``shard_params`` and ``attach_lora`` / ``insert_lora`` comes first.
``local_part`` and ``whole_part`` take a whole tensor's part along a
layer's sharded dimension and gather it back (training/lora.py).

Rank layout is row-major, ``rank = d * model + m``, as JAX's
``reshape(n // model, model)``. Every rank creates every subgroup, in one
order, or ``new_group`` deadlocks. A gloo collective cannot be captured
in a CUDA graph, so a model sharded over a gloo group decodes eagerly
(``Mesh.capturable``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from glimpseprune_torch.ops.cuda.int4_matmul import unpack_int4
from glimpseprune_torch.parallel.sequence import SeqShard

# JAX's table (glimpseprune_tpu/parallel/mesh.py:47-78): (regex on the
# 'a/b/c' parameter path, the sharded dim of the stacked JAX leaf, or
# None where it is replicated)
_RULES: Tuple[Tuple[str, Optional[int]], ...] = (
    (r"text/embed_tokens/embedding", 0),
    (r"text/layers/self_attn/(q_proj|k_proj|v_proj)/kernel(_q|_q4)?", 2),
    (r"text/layers/self_attn/(q_proj|k_proj|v_proj)/bias", 1),
    (r"text/layers/self_attn/o_proj/kernel(_q|_q4)?", 1),
    (r"text/layers/mlp/(gate_proj|up_proj)/kernel(_q|_q4)?", 2),
    (r"text/layers/mlp/(gate_proj|up_proj)/bias", 1),
    (r"text/layers/mlp/down_proj/kernel(_q|_q4)?", 1),
    (r"text/lm_head/kernel(_q|_q4)?", 1),
    (r"text/lm_head/kernel_scale4?", 1),
    (r"visual/blocks/attn/qkv/kernel(_q|_q4)?", 2),
    (r"visual/blocks/attn/qkv/bias", 1),
    (r"visual/blocks/attn/proj/kernel(_q|_q4)?", 1),
    (r"visual/blocks/mlp/(gate_proj|up_proj)/kernel(_q|_q4)?", 2),
    (r"visual/blocks/mlp/(gate_proj|up_proj)/bias", 1),
    (r"visual/blocks/mlp/down_proj/kernel(_q|_q4)?", 1),
    (r"visual/merger_fc1/kernel", 1),
    (r"visual/merger_fc1/bias", 0),
    (r"visual/merger_fc2/kernel", 0),
)

# what shard_params does: a Linear's JAX path (stacked layers unindexed,
# quantization._jax_path without "/kernel") -> (its unit, which is sharded
# whole or not at all, and its mode: "column", "row", or "qkv", the ViT's
# column-parallel qkv cut per (3, heads / tp, D)); the merger is left out
_TP_LAYERS: Dict[str, Tuple[str, str]] = {
    "text/layers/self_attn/q_proj": ("text_attn", "column"),
    "text/layers/self_attn/k_proj": ("text_attn", "column"),
    "text/layers/self_attn/v_proj": ("text_attn", "column"),
    "text/layers/self_attn/o_proj": ("text_attn", "row"),
    "text/layers/mlp/gate_proj": ("text_mlp", "column"),
    "text/layers/mlp/up_proj": ("text_mlp", "column"),
    "text/layers/mlp/down_proj": ("text_mlp", "row"),
    "text/lm_head": ("vocab", "column"),
    "visual/blocks/attn/qkv": ("vit_attn", "qkv"),
    "visual/blocks/attn/proj": ("vit_attn", "row"),
    "visual/blocks/mlp/gate_proj": ("vit_mlp", "column"),
    "visual/blocks/mlp/up_proj": ("vit_mlp", "column"),
    "visual/blocks/mlp/down_proj": ("vit_mlp", "row"),
}

_PACKED_KEYS = frozenset({"patches", "vis_pos_ids", "full_seg", "vis_valid"})


def param_sharding_rules(path: str) -> Optional[int]:
    """The dim over which JAX shards the leaf at ``path`` (a JAX parameter
    path, stacked layers unindexed), or None where it is replicated."""
    for pat, dim in _RULES:
        if re.fullmatch(pat, path):
            return dim
    return None


def mesh_shape(n: int, model_axis: Optional[int] = None) -> Dict[str, int]:
    """{"data": n // model, "model": model}; ``model_axis`` defaults to the
    largest of 4, 2 that divides n (else 1), as JAX's ``make_mesh``."""
    if model_axis is None:
        model_axis = next((c for c in (4, 2) if n % c == 0), 1)
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"a model axis of {model_axis} does not divide {n} ranks")
    return {"data": n // model_axis, "model": model_axis}


@dataclass(eq=False)
class Mesh:
    """This rank's place on a (data, model) mesh: the axis sizes, its
    coordinates and one process group per axis (None on a one-rank
    mesh)."""

    shape: Dict[str, int]
    data_index: int
    model_index: int
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def data(self) -> SeqShard:
        return SeqShard(self.data_group, self.data_index, self.shape["data"])

    @property
    def model(self) -> SeqShard:
        return SeqShard(self.model_group, self.model_index, self.shape["model"])

    def __deepcopy__(self, memo):  # a copied model stays on this mesh
        return self

    @property
    def capturable(self) -> bool:
        """False where the model axis runs over a process group whose
        collectives a CUDA graph cannot capture (gloo): a model sharded
        over it decodes eagerly."""
        return self.shape["model"] == 1 or dist.get_backend(self.model_group) == "nccl"


def make_mesh(n: Optional[int] = None, model_axis: Optional[int] = None) -> Mesh:
    """The (data, model) mesh over every rank of the initialized default
    group (n, when given, must be its size), or a 1 x 1 mesh without one.
    Collective: every rank must call it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n is not None and n != world:
        raise ValueError(f"make_mesh over {n} ranks, but the process group has {world}")
    shape = mesh_shape(world, model_axis)
    if world == 1:
        return Mesh(shape, 0, 0)
    d_size, m_size = shape["data"], shape["model"]
    d, m = divmod(dist.get_rank(), m_size)
    model_groups = [dist.new_group([i * m_size + j for j in range(m_size)])
                    for i in range(d_size)]
    data_groups = [dist.new_group([i * m_size + j for i in range(d_size)])
                   for j in range(m_size)]
    return Mesh(shape, d, m, data_groups[m], model_groups[d])


# ------------------------------------------------------------------ #
# shard_params


def _narrow(t: torch.Tensor, dim: int, tp: SeqShard) -> torch.Tensor:
    n = t.shape[dim] // tp.world
    return t.narrow(dim, tp.rank * n, n).clone(memory_format=torch.contiguous_format)


def _narrow_heads(t: torch.Tensor, dim: int, heads: int, tp: SeqShard) -> torch.Tensor:
    """The ViT qkv's [3, heads, D] columns along dim -> this rank's
    [3, heads / tp, D]."""
    shape = t.shape
    split = shape[:dim] + (3, heads, shape[dim] // (3 * heads)) + shape[dim + 1:]
    part = _narrow(t.reshape(split), dim + 1, tp)
    return part.reshape(shape[:dim] + (-1,) + shape[dim + 1:])


def _int4_rows(kernel_q4: torch.Tensor, kernel_scale4: torch.Tensor, tp: SeqShard):
    """A row-parallel shard of int4 weights: this rank's contraction rows
    [r K / tp, (r + 1) K / tp) of the whole layer, repacked as the
    block-halves of its local K / tp (the packing pairs row k with row
    k + K/2 of the whole dimension, so a slice of the packed rows is not
    the rank's rows), and the scale rows of the same groups."""
    q = unpack_int4(kernel_q4)  # [K, N]
    q = _narrow(q, 0, tp)
    half = q.shape[0] // 2
    packed = (q[:half] & 0x0F) | (q[half:] << 4)
    return packed.contiguous(), _narrow(kernel_scale4, 0, tp)


def _int4_row_fits(lin: nn.Module, world: int) -> bool:
    """Can an int4 row-parallel layer be cut ``world`` ways? Its local K
    must be a multiple of 2 g, as ``quantize_int4``'s packing asks of any
    int4 kernel; where not, its unit stays whole (unit-or-nothing)."""
    k = lin.in_features
    g = k // lin.kernel_scale4.shape[0]
    return k % world == 0 and (k // world) % (2 * g) == 0


def _narrow_param(p: Optional[nn.Parameter], cut) -> Optional[nn.Parameter]:
    if p is None:
        return None
    return nn.Parameter(cut(p.data), requires_grad=p.requires_grad)


def _shard_linear(lin: nn.Module, mode: str, tp: SeqShard, heads: int) -> None:
    """Keep lin's slice in place (a Linear's weight [out, in], a
    QuantLinear's int8 kernel_q [in, out] with its scale [1, out], or its
    int4 kernel_q4 [in/2, out] with its scales [in/g, out]; an adapter's
    ``lora_b`` columns on a column-parallel layer and ``lora_a`` rows on a
    row-parallel one) and mark it for its collective; mode "qkv" cuts the
    columns per head."""
    from glimpseprune_torch.models.layers import QuantLinear

    quant = isinstance(lin, QuantLinear)
    out_dim, in_dim = (1, 0) if quant else (0, 1)

    def cut(t, dim):
        return _narrow_heads(t, dim, heads, tp) if mode == "qkv" else _narrow(t, dim, tp)

    with torch.no_grad():
        if quant and lin.mode == "int4":
            if mode == "row":
                lin.kernel_q4, lin.kernel_scale4 = _int4_rows(lin.kernel_q4, lin.kernel_scale4,
                                                              tp)
            else:
                lin.kernel_q4 = cut(lin.kernel_q4, 1)
                lin.kernel_scale4 = cut(lin.kernel_scale4, 1)
            lin._set_layout()
        elif quant:
            if mode == "row":
                lin.kernel_q = _narrow(lin.kernel_q, 0, tp)
            else:
                lin.kernel_q = cut(lin.kernel_q, 1)
                lin.kernel_scale = cut(lin.kernel_scale, 1)
            lin._set_layout()
        else:
            lin.weight.data = cut(lin.weight.data, in_dim if mode == "row" else out_dim)
            lin.out_features, lin.in_features = lin.weight.shape
        if lin.bias is not None and mode != "row":
            lin.bias.data = cut(lin.bias.data, 0)
        if mode == "row":
            lin.lora_a = _narrow_param(lin.lora_a, lambda t: _narrow(t, 0, tp))
        else:
            lin.lora_b = _narrow_param(lin.lora_b, lambda t: cut(t, 1))
    lin.tp, lin.tp_mode = tp, "row" if mode == "row" else "column"
    lin.tp_heads = heads if mode == "qkv" else None


def local_part(lin: nn.Module, t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's part of a whole tensor ``t`` laid along lin's sharded
    dimension at ``dim`` (a weight's or an adapter's columns on a
    column-parallel layer, rows on a row-parallel one)."""
    if lin.tp_heads is not None:
        return _narrow_heads(t, dim, lin.tp_heads, lin.tp)
    return _narrow(t, dim, lin.tp)


def whole_part(lin: nn.Module, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole of a tensor that lin's ranks hold in parts along ``dim``
    (``local_part``'s inverse), on every rank. Collective over lin's model
    axis."""
    from glimpseprune_torch.parallel.sequence import _all_gather

    if lin.tp_heads is None:
        return _all_gather(t, dim, lin.tp)
    shape = t.shape
    split = shape[:dim] + (3, lin.tp_heads // lin.tp.world, -1) + shape[dim + 1:]
    whole = _all_gather(t.reshape(split), dim + 1, lin.tp)
    return whole.reshape(shape[:dim] + (-1,) + shape[dim + 1:])


def _refuse(model: nn.Module) -> None:
    if getattr(model, "mesh", None) is not None:
        raise ValueError("shard_params: the model is already sharded")


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Shard a Qwen2_5_VL_GP's or a Llava_GP's weights over the mesh's
    model axis, in place (each rank keeps its slice; the rest is freed),
    and bind the model to the mesh (``model.mesh``). Each Linear /
    QuantLinear of ``_TP_LAYERS`` (with its adapters, where it carries
    them) is sharded in its mode where its unit (a tower's attention, its
    MLP, the vocab) divides the axis, and stays replicated where not; the
    embedding goes with the vocab. A unit also stays whole where one of
    its int4 row-parallel layers would hold a local contraction that is no
    multiple of 2 g (``_int4_row_fits``), and a ViT unit with int4
    layers stays whole (the module docstring says why). LLaVA's CLIP
    towers and projector match no rule: they stay whole, as in JAX.
    Returns the model."""
    from glimpseprune_torch.models.layers import Linear, QuantLinear
    from glimpseprune_torch.models.qwen2_5_vl.vision import VisionTransformer
    from glimpseprune_torch.quantization import _jax_path

    _refuse(model)
    model.mesh = mesh
    m = mesh.shape["model"]
    if m == 1:
        return model
    tp = mesh.model
    text, vis = model.text, model.visual
    tc, vc = text.cfg, model.cfg.vision
    vit = isinstance(vis, VisionTransformer)
    divides = {
        "text_attn": tc.num_attention_heads % m == tc.num_key_value_heads % m == 0,
        "text_mlp": tc.intermediate_size % m == 0,
        "vocab": tc.vocab_size % m == 0,
        "vit_attn": vit and vc.num_heads % m == 0,
        "vit_mlp": vit and vc.intermediate_size % m == 0,
    }
    layers = []
    for name, mod in model.named_modules():
        if not isinstance(mod, (Linear, QuantLinear)):
            continue
        unit, mode = _TP_LAYERS.get(_jax_path(name).removesuffix("/kernel"), (None, None))
        if unit is None:
            continue
        layers.append((mod, unit, mode))
        int4 = isinstance(mod, QuantLinear) and mod.mode == "int4"
        if int4 and (unit.startswith("vit_") or mode == "row" and not _int4_row_fits(mod, m)):
            divides[unit] = False
    for mod, unit, mode in layers:
        if divides[unit]:
            _shard_linear(mod, mode, tp, vc.num_heads)
    if divides["text_attn"]:
        text.attn_tp = tp
    if divides["vit_attn"]:
        vis.attn_tp = tp
    if divides["vocab"]:
        with torch.no_grad():
            text.embed_tokens.weight.data = _narrow(text.embed_tokens.weight.data, 0, tp)
        text.vocab_tp = tp
    return model


def shard_batch(batch: Dict[str, Optional[torch.Tensor]], mesh: Mesh) -> Dict:
    """This data rank's rows of each per-example array of a batch dict
    (the train step's, trainer.batch_from_prep): the leading dim, or dim 1
    of ``position_ids`` [3, B, S]. The packed vision arrays (the ViT runs
    on every image of the batch), 0-d arrays and arrays whose batch dim
    does not divide the data axis stay whole, as in JAX (mesh.py:105-132)."""
    dsh = mesh.data
    out = {}
    for k, v in batch.items():
        dim = 1 if k == "position_ids" else 0
        if (v is None or k in _PACKED_KEYS or v.ndim <= dim or dsh.world == 1
                or v.shape[dim] % dsh.world):
            out[k] = v
        else:
            out[k] = v.narrow(dim, dsh.rank * (v.shape[dim] // dsh.world),
                              v.shape[dim] // dsh.world)
    return out

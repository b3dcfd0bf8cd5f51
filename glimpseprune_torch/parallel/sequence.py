"""Sequence parallelism (SP): the prefill's sequence split over the ranks
of a ``torch.distributed`` process group.

Counterpart of glimpseprune_tpu/parallel/mesh.py:135-171
(``enable_sequence_parallel``, ``sequence_parallel``) and of the SP state
in glimpseprune_tpu/ops/attention.py:59-96 (``_sp_split``). In JAX, SP
turns the attention choke points into ``shard_map`` programs and GSPMD
shards everything between them. PyTorch has no GSPMD, so the layer stacks
shard the sequence themselves (models/qwen2_5_vl/vision.py and
language.py) and cross between replicated and sharded tensors through the
three collectives below, each an autograd function whose backward is the
collective that the forward's use of the result asks for:

- ``split_seq``: replicated -> this rank's shard. Forward: a slice.
  Backward: all-gather of the shard gradients (each rank holds the
  gradient of its own shard only).
- ``gather_seq``: shards -> replicated, when what follows is replicated
  (every rank computes the same thing on the whole). Forward: all-gather.
  Backward: this rank's slice of the gradient, with no sum (every rank
  holds the same whole gradient).
- ``gather_kv``: shards -> the whole, when what follows is sharded (each
  rank's queries attend over every key). Forward: all-gather. Backward:
  the sum over ranks of the gradient, then this rank's slice.

Only ``dist.all_gather`` (the list form) and ``dist.all_reduce`` are used:
gloo implements both for CPU and CUDA tensors (it has no reduce-scatter,
so ``gather_kv``'s backward is an all-reduce and a slice). Gathers move
the tensors' bytes (a uint8 view), so every dtype crosses bit for bit on
any backend; the all-reduce sums in fp32 or wider. The group and its backend are
the caller's.

The setting is read at each call (``get_sequence_parallel``): eager
PyTorch binds nothing at trace time, so a runner or train step built
outside ``sequence_parallel`` runs sharded inside it. Each call site
shards only when its length divides into ``n * multiple`` (``sp_split``),
and runs unsharded otherwise, as JAX's per-call-site rule does.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, NamedTuple, Optional

import torch
import torch.distributed as dist

_SP_GROUP: Optional[dist.ProcessGroup] = None


class SeqShard(NamedTuple):
    """Where this rank's shard of one sharded sequence sits."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int

    def slice(self, total: int) -> slice:
        """This rank's rows of a sequence of ``total`` rows."""
        n = total // self.world
        return slice(self.rank * n, (self.rank + 1) * n)


def enable_sequence_parallel(group: Optional[dist.ProcessGroup]) -> None:
    """Shard the prefill over ``group`` (e.g. ``dist.group.WORLD``), or turn
    SP off with None."""
    global _SP_GROUP
    if group is not None and not dist.is_initialized():
        raise RuntimeError("sequence parallelism needs an initialized process group")
    _SP_GROUP = group


def get_sequence_parallel() -> Optional[SeqShard]:
    """This rank's place in the active SP group, or None when SP is off."""
    if _SP_GROUP is None:
        return None
    return SeqShard(_SP_GROUP, dist.get_rank(_SP_GROUP), dist.get_world_size(_SP_GROUP))


@contextlib.contextmanager
def sequence_parallel(group: dist.ProcessGroup) -> Iterator[None]:
    """Context-manager form of ``enable_sequence_parallel``; restores the
    previous setting (not necessarily "off") on exit."""
    prev = _SP_GROUP
    enable_sequence_parallel(group)
    try:
        yield
    finally:
        enable_sequence_parallel(prev)


def sp_split(total: int, multiple: int = 1) -> Optional[SeqShard]:
    """The active shard when SP is on and ``total`` splits into n equal
    ``multiple``-aligned shards; None otherwise (the call site then runs
    unsharded)."""
    sp = get_sequence_parallel()
    if sp is None or sp.world <= 1 or total % (sp.world * multiple) != 0:
        return None
    return sp


def _all_gather(x: torch.Tensor, dim: int, sp: SeqShard) -> torch.Tensor:
    """The ranks' tensors concatenated along dim, moved as bytes."""
    x = x.contiguous()
    xb = x.view(torch.uint8)
    parts = [torch.empty_like(xb) for _ in range(sp.world)]
    dist.all_gather(parts, xb, group=sp.group)
    return torch.cat([p.view(x.dtype) for p in parts], dim)


def _local(x: torch.Tensor, dim: int, sp: SeqShard) -> torch.Tensor:
    return x.narrow(dim, sp.rank * (x.shape[dim] // sp.world), x.shape[dim] // sp.world)


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sp):
        ctx.dim, ctx.sp = dim, sp
        return _local(x, dim, sp).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.sp), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sp):
        ctx.dim, ctx.sp = dim, sp
        return _all_gather(x, dim, sp)

    @staticmethod
    def backward(ctx, grad):
        return _local(grad, ctx.dim, ctx.sp).contiguous(), None, None


class _GatherKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sp):
        ctx.dim, ctx.sp = dim, sp
        return _all_gather(x, dim, sp)

    @staticmethod
    def backward(ctx, grad):
        total = grad.to(torch.promote_types(grad.dtype, torch.float32),
                        memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(total, group=ctx.sp.group)
        return _local(total, ctx.dim, ctx.sp).to(grad.dtype).contiguous(), None, None


def split_seq(x: torch.Tensor, dim: int, sp: SeqShard) -> torch.Tensor:
    """This rank's shard of a replicated tensor along ``dim``; backward:
    all-gather of the shard gradients."""
    return _SplitSeq.apply(x, dim, sp)


def gather_seq(x: torch.Tensor, dim: int, sp: SeqShard) -> torch.Tensor:
    """The whole of a sharded tensor, for replicated compute; backward:
    this rank's slice of the (replicated) gradient."""
    return _GatherSeq.apply(x, dim, sp)


def gather_kv(x: torch.Tensor, dim: int, sp: SeqShard) -> torch.Tensor:
    """The whole of a sharded tensor, for sharded compute (K/V for local
    queries); backward: the sum of the ranks' gradients, sliced."""
    return _GatherKV.apply(x, dim, sp)

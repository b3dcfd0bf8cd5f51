"""Parallelism over ``torch.distributed``: the (data, model) mesh with
tensor parallelism and the data split (``mesh``), sequence parallelism for
the prefill (``sequence``) and a launcher for N-process groups
(``launch``)."""

from glimpseprune_torch.parallel.launch import launch
from glimpseprune_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_shape,
    param_sharding_rules,
    shard_batch,
    shard_params,
)
from glimpseprune_torch.parallel.sequence import (
    SeqShard,
    enable_sequence_parallel,
    gather_kv,
    gather_seq,
    get_sequence_parallel,
    sequence_parallel,
    sp_split,
    split_seq,
)

__all__ = ["Mesh", "SeqShard", "enable_sequence_parallel", "gather_kv", "gather_seq",
           "get_sequence_parallel", "launch", "make_mesh", "mesh_shape",
           "param_sharding_rules", "sequence_parallel", "shard_batch", "shard_params",
           "sp_split", "split_seq"]

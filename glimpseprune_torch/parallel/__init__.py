"""Parallelism over ``torch.distributed``: sequence parallelism for the
prefill (``sequence``) and a launcher for N-process groups (``launch``)."""

from glimpseprune_torch.parallel.launch import launch
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

__all__ = ["SeqShard", "enable_sequence_parallel", "gather_kv", "gather_seq",
           "get_sequence_parallel", "launch", "sequence_parallel", "sp_split", "split_seq"]

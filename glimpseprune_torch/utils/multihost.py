"""Multi-process helpers: the ranks' count and index, a gather of one
JSON-able object per rank, and the merge of per-rank result files.

Counterpart of glimpseprune_tpu/utils/multihost.py (``num_hosts`` :19,
``host_id`` :25, ``gather_objects`` :31, ``merge_host_results`` :56). A
host of the JAX package is a rank of the default ``torch.distributed``
group here; without an initialized group every helper is the one-process
identity, so harness code is topology-agnostic.
"""

from __future__ import annotations

import json
from typing import Any, List

import torch
import torch.distributed as dist


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def num_hosts() -> int:
    return dist.get_world_size() if _grouped() else 1


def host_id() -> int:
    return dist.get_rank() if _grouped() else 0


def _gather_device() -> torch.device:
    """Where the group's collectives take their tensors: the card under
    NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_objects(obj: Any, max_bytes: int = 1 << 22) -> List[Any]:
    """All-gather one JSON-able object per rank -> the list, in rank order;
    ``[obj]`` without a group. A payload over ``max_bytes - 8`` bytes (the
    JAX package's limit) raises ValueError on every rank: the lengths are
    gathered first, then the payloads padded to the longest."""
    if num_hosts() == 1:
        return [obj]
    payload = json.dumps(obj).encode()
    dev = _gather_device()
    lengths = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(num_hosts())]
    dist.all_gather(lengths, torch.tensor([len(payload)], dtype=torch.int64, device=dev))
    lengths = [int(n) for n in lengths]
    too_large = [r for r, n in enumerate(lengths) if n > max_bytes - 8]
    if too_large:
        raise ValueError(f"object too large to gather ({lengths[too_large[0]]} bytes on rank "
                         f"{too_large[0]}, limit {max_bytes - 8})")
    width = max(lengths)
    buf = torch.zeros(width, dtype=torch.uint8, device=dev)
    buf[:len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    parts = [torch.empty_like(buf) for _ in lengths]
    dist.all_gather(parts, buf)
    return [json.loads(bytes(p[:n].cpu().numpy()).decode()) for p, n in zip(parts, lengths)]


def merge_host_results(jsonl_paths: List[str], out_path: str) -> int:
    """Concatenate per-rank shard jsonls (``infer_viscot`` shards) into one
    file, de-duplicated by question_id, in a stable order -> records
    written."""
    seen = set()
    n = 0
    with open(out_path, "w") as out:
        for p in jsonl_paths:
            with open(p) as f:
                for line in f:
                    rec = json.loads(line)
                    qid = rec.get("question_id")
                    if qid in seen:
                        continue
                    seen.add(qid)
                    out.write(line if line.endswith("\n") else line + "\n")
                    n += 1
    return n

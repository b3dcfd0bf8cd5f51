"""Start N processes in one ``torch.distributed`` group and collect what
each returns.

The rendezvous is a ``file://`` store in a fresh temporary directory, so
launches running side by side (parallel test workers) never race for a
port. The backend is the caller's: ``"gloo"`` runs on CPU tensors and, on
one card, on CUDA tensors of several processes (NCCL refuses two ranks on
one device).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List

import torch.distributed as dist


def _worker(fn, rank, world, backend, init_file, timeout_s, args, results):
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the parent re-raises it with the rank's traceback
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable[..., Any], world_size: int, *args, backend: str,
           timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, each a rank of one process group over ``backend``; -> the
    ranks' return values in rank order. ``fn`` and ``args`` must pickle
    (``fn`` a module-level function). Raises, with the failing ranks'
    tracebacks, if a rank raises or dies, or if the ranks do not finish
    within ``timeout_s``; every process is stopped before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="sp_rendezvous_")
    init_file = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, r, world_size, backend, init_file, timeout_s, args, results))
             for r in range(world_size)]
    outs, errors, finished = {}, {}, False
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(outs) < world_size and not errors:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):  # a rank that died without a word
                    if r not in outs and p.exitcode not in (None, 0):
                        errors[r] = f"died with exit code {p.exitcode}"
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: ranks {sorted(set(range(world_size)) - set(outs))}"
                                       f" did not finish in {timeout_s} s")
                continue
            (outs if ok else errors)[rank] = out
        if errors:
            raise RuntimeError("launch: " + "\n".join(
                f"rank {r}:\n{e}" for r, e in sorted(errors.items())))
        finished = True
        return [outs[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive() and not finished:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)

"""Shared pieces of the CPU tests: a copy of the benchmark's data and
readers beside the tiny test cells, and one tiny run through the program
and the reference."""

from __future__ import annotations

import shutil
import time
from pathlib import Path
from unittest import mock

import torch

from gpbench import harness

HERE = Path(__file__).resolve().parent
TINY = "tiny.tiny_vqa"


def tiny_root(tmp: Path) -> Path:
    """A benchmark folder under tmp: the real configs, traffic, workloads
    and metric readers, with the tiny test cells added."""
    root = tmp / "bench"
    for d in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(harness.ROOT / d, root / d)
        extra = HERE / "data" / d
        if extra.is_dir():
            for f in extra.iterdir():
                shutil.copy(f, root / d / f.name)
    return root


def tiny_run(root: Path, name: str = TINY, traced: bool = False, tier=None,
             seed: int = 2 ** 33 + 7):
    torch.set_num_threads(2)
    with mock.patch.object(harness, "JUDGE_REQUESTS", 3):
        return harness.run(name, seed, 0.0, traced, time.perf_counter(), device="cpu",
                           root=root, tier=tier)

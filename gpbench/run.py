"""The benchmark's command:

    python3 -m gpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It runs one cell of BENCHMARK.json on this
machine's card and prints, as the last line of standard output, one JSON
object (correct, attempted, failed, metrics, device, with --trace 1 a
breakdown, and last the numbers compared with their limits). Without a
card it exits non-zero and prints no result: nothing falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="gpbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def keep_caches_in_checkout() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's nvcc builds already live in build/glimpseprune_torch)."""
    cache = CHECKOUT / "build" / "gpbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    args = parse(argv)
    keep_caches_in_checkout()
    import torch

    from gpbench import harness

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"gpbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                      device="cuda", benchmark=bench)
    loaded = sorted({k.split(".")[0] for k in sys.modules} & set(harness.FORBIDDEN))
    if loaded:
        print(f"gpbench: the run loaded {loaded}", file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

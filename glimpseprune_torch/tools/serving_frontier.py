"""The continuous protocol's capacity ladder over tiers: counterpart of
tools/serving_frontier.py.

For each point B x kv x weights (``--batches`` x ``--kv`` x ``--weights``,
or ``--points B:kv:weights,...`` in the order given) it runs
``bench_protocols``' continuous mode at the 7B: the pruned side from B
down its OOM ladder, the unpruned side from ``--rows-u``, every rung in a
process of its own, one at a time, the processes' output in a log per
point (``<out>.logs/B<B>_<kv>_<weights>.log``). The unpruned side does not
depend on B: it is measured once per (kv, weights) tier within a run and
reused by that tier's later points (``unpruned_reused: true``), held in
memory, never in a file a later run could read. Rows carry JAX's keys;
``B_actual`` is the pruned B the ladder served. ``--out`` (default
``build/serving_frontier.json``) is rewritten after every point, and a
point already in it without an error is skipped.

  python -m glimpseprune_torch.tools.serving_frontier --batches 8,16,32 --kv int8 \\
      --weights int8 --decode 1024
  python -m glimpseprune_torch.tools.serving_frontier --points 48:int8:int8 --dry

Flags after ``--`` go to ``bench_protocols`` as they are (e.g. ``--device
cpu --scale tiny --max-pixels 12544``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence

from glimpseprune_torch.tools import bench_protocols

DEFAULT_OUT = os.path.join(str(bench_protocols.ROOT), "build", "serving_frontier.json")


def point_argv(B: int, kv: str, weights: str, n_dec: int, rows_u: int) -> List[str]:
    """bench_protocols' flags of one point (JAX's run_point environment)."""
    return ["--mode", "continuous", "--scale", "7b", "--quant", weights,
            "--kv-quant", kv if kv != "fp" else "none", "--serve-rows-p", str(B),
            "--serve-rows-u", str(rows_u), "--decode", str(n_dec),
            # both weight tiers ride the W8A8 / W4A8 prefill tier (JAX: setdefault)
            "--act-quant", os.environ.get("BENCH_ACT_QUANT", "prefill")]


def run_point(B, kv, weights, n_dec, rows_u, timeout_s, log_dir, extra=(), unpruned=None):
    """-> (row, the unpruned side's record to reuse or None)."""
    t0 = time.time()
    args = bench_protocols.parse_args(point_argv(B, kv, weights, n_dec, rows_u) + list(extra))
    os.makedirs(log_dir, exist_ok=True)
    logp = os.path.join(log_dir, f"B{B}_{kv}_{weights}.log")
    with open(logp, "w") as lf:
        try:
            run = bench_protocols.run_continuous(args, unpruned, log=lf, timeout=timeout_s)
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            timed_out = isinstance(e, subprocess.TimeoutExpired)
            lf.write(f"{type(e).__name__}: {e}\n")
            with open(logp) as f:
                tail = f.read().strip().splitlines()[-12:]
            return {"B": B, "kv": kv, "weights": weights, "error": True,
                    "rc": "timeout" if timed_out else "failed", "log": logp,
                    "tail": "\n".join(tail), "wall_s": round(time.time() - t0, 1)}, None
        lf.write(json.dumps(run.result) + "\n")
    d, det = run.result, run.result["detail"]
    return {
        "B": B, "B_actual": det.get("pruned_batch"),
        "B_u_actual": det.get("unpruned_batch"), "kv": kv, "weights": weights,
        "tok_s": d["value"],
        "vs_unpruned": d["vs_baseline"],
        "ttft_mean_s": det.get("pruned_ttft", {}).get("mean_s"),
        "ttft_max_s": det.get("pruned_ttft", {}).get("max_s"),
        "unpruned_tok_s": det.get("unpruned_tok_s"),
        "unpruned_ttft_mean_s": det.get("unpruned_ttft", {}).get("mean_s"),
        "pruned_wall_s": det.get("pruned_wall_s"),
        "unpruned_reused": det.get("unpruned_reused"),
        "n_decode": det.get("n_decode"),
        "act_quant": det.get("act_quant"),
        "wall_s": round(time.time() - t0, 1),
    }, run.sides["unpruned"]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run (or, with ``--dry``, list) the points; returns what ``--out``
    holds."""
    argv = list(sys.argv[1:] if argv is None else argv)
    extra: List[str] = []
    if "--" in argv:
        extra, argv = argv[argv.index("--") + 1:], argv[:argv.index("--")]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--batches", default="8,12,16")
    ap.add_argument("--kv", default="int8,fp")
    ap.add_argument("--weights", default="int8,int4")
    ap.add_argument("--decode", type=int, default=1024)
    ap.add_argument("--rows-u", type=int, default=7,
                    help="the unpruned side's first rung (the bench's default)")
    ap.add_argument("--timeout", type=int, default=3600, help="seconds a rung's process")
    ap.add_argument("--points", default=None,
                    help="explicit ordered points 'B:kv:weights,...' (overrides the "
                    "--batches/--kv/--weights product)")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args(argv)

    if args.points:
        points = []
        for spec in args.points.split(","):
            b, kv, w = spec.split(":")
            points.append((int(b), kv, w))
    else:
        points = list(itertools.product([int(b) for b in args.batches.split(",")],
                                        args.kv.split(","), args.weights.split(",")))
    if args.dry:
        for p in points:
            print(p)
        return {"points": points}

    rows = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f).get("rows", [])
    done = {(r["B"], r["kv"], r["weights"]) for r in rows if not r.get("error")}
    unpruned = {}  # (kv, weights) -> the unpruned side's record, this run only
    out = {}
    for B, kv, w in points:
        if (B, kv, w) in done:
            print(f"skip (done): B={B} kv={kv} w={w}")
            continue
        print(f"running: B={B} kv={kv} weights={w} ...", flush=True)
        row, un = run_point(B, kv, w, args.decode, args.rows_u, args.timeout,
                            args.out + ".logs", extra, unpruned.get((kv, w)))
        if un is not None:
            unpruned[(kv, w)] = un
        rows = [r for r in rows if not (r["B"] == B and r["kv"] == kv and r["weights"] == w)]
        rows.append(row)
        print(json.dumps(row), flush=True)
        out = {"protocol": "bench_protocols --mode continuous per point; both sides timed; "
                           "the unpruned side measured once per (kv, weights) tier",
               "n_decode": args.decode, "rows_u": args.rows_u,
               "rows": sorted(rows, key=lambda r: (r["weights"], r["kv"], r["B"]))}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()

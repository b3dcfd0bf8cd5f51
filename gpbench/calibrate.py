"""Readings that set a cell's limits: the numbers compared over many seeds,
for the program as the configuration states it and for the control (the
program in its configuration's ``control_tier``, the next precision down).
The benchmark's own runs never run it. On the card, from the root of a
checkout:

    python3 -m gpbench.calibrate --workload <cell> --seeds 11,12,13 [--control] [--seconds 0]

With ``--fault <name>`` the program runs with that fault of
``gpbench.faults`` planted, which the check has to call not correct. Each
seed runs a whole cell (weights, inputs, the warm-up, a window of at
least one episode, the reference's check) in this one process, and prints
one JSON line of its checks and judged requests.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from gpbench import faults, harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control", action="store_true",
                    help="run the program in the configuration's control tier")
    ap.add_argument("--tier", default=None,
                    help="a tier as JSON in place of the configuration's (a second witness)")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None,
                    help="plant this fault in the program's timed path")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sp = harness.spec(args.workload)
    tier = sp.config["control_tier"] if args.control else None
    if args.tier:
        tier = json.loads(args.tier)
    if args.fault:
        faults.plant(args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run(args.workload, seed, args.seconds, False, t0, device=args.device,
                          tier=tier)
        print(json.dumps({"seed": seed, "tier": tier or sp.config["tier"], "fault": args.fault,
                          "correct": out["correct"], "checks": out["checks"],
                          "judged": out["judged"],
                          "metrics": out["metrics"], "s": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

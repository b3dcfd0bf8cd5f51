"""The reduce layer swept through the e2e protocol: counterpart of
tools/sweep_reduce_layer.py.

The 7B recipe pins the reduce layer at 18 of 28 with the ViT unpruned,
which caps the prefill speedup at (V + 28 L) / (V + 19 L) whatever the
implementation. Per ``--layers`` point this runs ``bench_protocols.run_e2e``
with the reduce layer moved there (``bench_config(scale, layer)``) and the
same tiers on both sides: int8 weights unless BENCH_QUANT says otherwise,
W8A8 only where BENCH_ACT_QUANT asks (the JAX sweep calls ``bench.run``
without ``main``'s defaults). The unpruned baseline is measured again at
every point: it does not depend on the layer, so its agreement across
points is a stability check. One JSON row per point on stdout as it lands,
then the whole to ``--out`` (default ``build/sweep_reduce_layer.json``).

  python -m glimpseprune_torch.tools.sweep_reduce_layer --layers 6,12,18 --decode 128

Flags after ``--`` go to ``bench_protocols`` as they are (e.g. ``--device
cpu --max-pixels 12544``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from typing import List, Optional, Sequence

from glimpseprune_torch.tools import bench_protocols

DEFAULT_OUT = os.path.join(str(bench_protocols.ROOT), "build", "sweep_reduce_layer.json")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the sweep; returns what ``--out`` holds."""
    argv = list(sys.argv[1:] if argv is None else argv)
    extra: List[str] = []
    if "--" in argv:
        extra, argv = argv[argv.index("--") + 1:], argv[:argv.index("--")]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", default="2,6,10,14,18")
    ap.add_argument("--decode", type=int, default=128)
    ap.add_argument("--scale", default="7b")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    import torch

    quant = os.environ.get("BENCH_QUANT", "int8")
    act = os.environ.get("BENCH_ACT_QUANT", "none") or "none"
    rows = []
    for rl in [int(x) for x in args.layers.split(",")]:
        bargs = bench_protocols.parse_args(
            ["--mode", "e2e", "--scale", args.scale, "--quant", quant, "--act-quant", act,
             "--decode", str(args.decode), "--reduce-layer", str(rl)] + extra)
        r = bench_protocols.run_e2e(bargs).result
        row = {"reduce_layer": rl,
               "prefill_ratio": r["detail"]["prefill_ratio"],
               "e2e_ratio": r["detail"].get("e2e_ratio"),
               "prefill_pruned_ms": r["detail"]["prefill_pruned_ms"],
               "prefill_unpruned_ms": r["detail"]["prefill_unpruned_ms"],
               "e2e_generate_ms": r["detail"].get("e2e_generate_ms"),
               "n_image_tokens": r["detail"]["n_image_tokens"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    out = {"scale": args.scale, "quant": quant, "act_quant": act, "decode": args.decode,
           "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()

"""K2 with segment ids at the 16k-token image's ViT full-attention shape,
on the card: counterpart of tools/sweep_vit_fullatt.py.

The ViT's four full-attention blocks attend over all P = 65,536 patches of
the 16k-token image, H = 16 heads of D = 80. The JAX tool timed its flash
kernel there with all-zero segment ids (not the dense flavour) over six
(block_q, block_k) tiles. K2's forward has one tile a head dim, fixed at
compile time, so this tool has one K2 row in that flavour,
``flash_attention[segmented]``, and beside it, in the same call and on the
same inputs, the dense K2 and ``scaled_dot_product_attention`` under each
backend that runs at this shape (flash, memory-efficient, cuDNN; "best_sdpa"
names the fastest): the segment-id path's cost at this shape, read
directly. q, k and v come from numpy.random.default_rng(0) as in JAX.

Each row: event ms (CUDA events over ``--iters`` calls after a warm-up),
device ms (torch.profiler), the bound and its share, the JAX tool's TF/s
(4 S^2 D H), the launches a call, and the output held to K2's plain version
on ``--check-rows`` q rows. The card's name and power limit come first; the
JSON goes to stdout and to chiprun_out/sweep_vit_fullatt.json. Without a
card it fails unless given ``--device cpu`` (plain versions, small sizes,
"not measured" for every time).

  python -m glimpseprune_torch.tools.sweep_vit_fullatt
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from glimpseprune_torch.tools import kernel_ab as ab
from glimpseprune_torch.tools.common import resolve_device
from glimpseprune_torch.tools.sweep_vision_attention import k2_and_library

TOOL = "sweep_vit_fullatt"


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--seq", type=int, default=65536, help="patches attended over")
    ap.add_argument("--iters", type=int, default=10, help="timed calls a row")
    ap.add_argument("--check-rows", type=int, default=256,
                    help="q rows on which each output is held to the plain version")
    ap.add_argument("--out", default=None, help="default chiprun_out/sweep_vit_fullatt.json")
    return ap.parse_args(argv)


def best_sdpa(rows) -> Optional[str]:
    """The SDPA row with the least device ms (event ms where the device
    time was not measured), or None where none ran on the card."""
    timed = [r for r in rows if r["name"].startswith("sdpa") and r["ms"] != ab.NOT_MEASURED]
    key = lambda r: r["ms"] if r["device_ms"] == ab.NOT_MEASURED else r["device_ms"]  # noqa: E731
    return min(timed, key=key)["name"] if timed else None


def run(args) -> Dict[str, Any]:
    """-> the record (its "failures" list empty when every check held)."""
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    card = ab.card_line() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    b, h, s, d = 1, 16, args.seq, 80
    with torch.inference_mode():
        q, k, v = ab.numpy_qkv(b, h, s, d, dev, dtype)
        seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
        idx = ab.check_rows(s, args.check_rows, dev)
        rows = k2_and_library(args, dev, q, k, v, seg, ("segmented", "dense"), idx)
    failures = [f"{r['name']}: {r}" for r in rows[:2] if not r["ok"]]
    failures += ab.launch_failures(rows, dev)
    return {"tool": TOOL, "card": card, "device": str(dev), "shape": [b, h, s, d],
            "iters": args.iters, "check_rows": int(idx.numel()), "rows": rows,
            "best_sdpa": best_sdpa(rows), "failures": failures}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run, write the report; SystemExit if a check failed."""
    args = parse_args(argv)
    record = run(args)
    ab.write_report(TOOL, record, args.out)
    if record["failures"]:
        raise SystemExit(f"{TOOL}: {len(record['failures'])} checks failed: "
                         f"{record['failures'][:3]}")
    return record


if __name__ == "__main__":
    main()

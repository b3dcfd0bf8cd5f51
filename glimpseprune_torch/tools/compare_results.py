"""Side-by-side comparison of two eval result jsonls; counterpart of
tools/compare_results.py (the text / JSON report version of the
reference's Gradio browser, results_vis_compare.py).

Joins the two files on ``question_id`` and reports the mean IoU, mask ratio
and generated length of the joined rows on each side, the mean score where
both have a ``*_score.jsonl`` beside them, and the first ``--show`` rows'
response pairs.

  python -m glimpseprune_torch.tools.compare_results results/a_generate.jsonl \\
      results/b_generate.jsonl --json-out report.json
"""

from __future__ import annotations

import argparse
import json
import os
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np


def load_jsonl(path):
    with open(path) as f:
        return OrderedDict((r["question_id"], r) for r in map(json.loads, f))


def load_scores(path):
    score_path = path.replace(".jsonl", "_score.jsonl")
    if not os.path.exists(score_path):
        return {}
    with open(score_path) as f:
        return {r["question_id"]: r["score"] for r in map(json.loads, f)}


def agg(rows, key):
    vals = [r[key] for r in rows if r.get(key) is not None]
    return float(np.mean(vals)) if vals else None


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns the report it prints."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--show", type=int, default=5, help="sample rows to print")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    A, B = load_jsonl(args.a), load_jsonl(args.b)
    sa, sb = load_scores(args.a), load_scores(args.b)
    common = [k for k in A if k in B]

    report = {"a": args.a, "b": args.b, "common_samples": len(common), "metrics": {}}
    for key in ("iou", "mask_ratio", "num_gen_tokens"):
        ma = agg([A[k] for k in common], key)
        mb = agg([B[k] for k in common], key)
        if ma is not None or mb is not None:
            report["metrics"][key] = {"a": ma, "b": mb}
    if sa and sb:
        report["metrics"]["score"] = {
            "a": float(np.mean([sa[k] for k in common if k in sa])),
            "b": float(np.mean([sb[k] for k in common if k in sb])),
        }

    print(json.dumps(report, indent=2))
    for k in common[: args.show]:
        print(f"\n--- question_id={k}")
        print(f"  Q: {A[k].get('query', '')[:120]}")
        print(f"  A: {A[k].get('response')}")
        print(f"  B: {B[k].get('response')}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()

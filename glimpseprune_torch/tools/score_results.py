"""Score eval result jsonls (reference viscot_eval/cal_cot_score.py);
counterpart of tools/score_results.py.

Offline scorers run locally; --judge-url enables the LLM judge over any
OpenAI-compatible endpoint (vLLM etc.). Line-level resume by default. No
model and no card: this is host-side Python.

  python -m glimpseprune_torch.tools.score_results results/gqa/gqa_generate.jsonl \\
      --scorer llm --judge-url http://localhost:8000/v1 --judge-model Qwen2.5-32B-Instruct
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Run the CLI; returns one summary per results file."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("results", nargs="+")
    ap.add_argument("--scorer", default="precise_match")
    ap.add_argument("--judge-url", default=None)
    ap.add_argument("--judge-model", default="judge")
    ap.add_argument("--judge-api-key", default="EMPTY")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--overwrite", action="store_true")
    args = ap.parse_args(argv)

    from glimpseprune_torch.evalsuite import LLMClient, score_results

    client = None
    if args.judge_url:
        client = LLMClient(args.judge_url, args.judge_api_key, args.judge_model)
    summaries = []
    for path in args.results:
        summary = score_results(
            path, scorer=args.scorer, batch_size=args.batch_size,
            client=client, overwrite=args.overwrite,
        )
        print(json.dumps({"file": path, **summary}))
        summaries.append({"file": path, **summary})
    return summaries


if __name__ == "__main__":
    main()

"""Result scoring: offline scorers + LLM judge, with line-level resume.

Offline scorer semantics match the reference (viscot_eval/cal_cot_score.py:
346-404): precise_match, single_choice (regex letter extraction), and
one_box_iou05 (predicted bbox IoU > 0.5). `score_results` walks a results
jsonl, skips already-scored lines (resume, reference :30-56), and writes
`<name>_score.jsonl` plus a summary.

A copy of glimpseprune_tpu/evalsuite/scorers.py over the port's registry;
tests/test_torch_evalsuite.py holds the two equal.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from glimpseprune_torch.registry import Registry

SCORERS: Registry = Registry("scorer")


@SCORERS.register("precise_match")
def precise_match(queries, gt_resp, pred_resp, **kw) -> List[float]:
    return [1.0 if g == p else 0.0 for g, p in zip(gt_resp, pred_resp)]


_CHOICE_PATTERNS = [
    r"(?:(?:the|my|the correct)\s+)?(?:answer|choice|option)\s*(?:is)?\s*[:：]?\s*([A-Z])",
    r"\(([A-Z])\)",
    r"\b([A-Z])[\.\)]",
    r"^([A-Z])\b",
    r"\b([A-Z])\b",
]


@SCORERS.register("single_choice")
def single_choice(queries, gt_resp, pred_resp, **kw) -> List[float]:
    scores = []
    for g, p in zip(gt_resp, pred_resp):
        g = (g or "").strip().upper()
        extracted = None
        for pat in _CHOICE_PATTERNS:
            m = re.search(pat, p or "", re.IGNORECASE)
            if m:
                extracted = m.group(1).upper()
                break
        scores.append(1.0 if extracted and extracted == g else 0.0)
    return scores


def extract_one_bbox_from_str(text: str) -> List[float]:
    """First [x1, y1, x2, y2] integer list in the text; zeros if none.

    The EXACT reference pattern (utils.py:45-57): integers only, no space
    after '[' or before commas — a looser pattern would extract (and score)
    boxes the reference's evaluator rejects. Differential-fuzzed in
    tests/test_evalsuite.py."""
    m = re.search(r"\[(\d+),\s*(\d+),\s*(\d+),\s*(\d+)\]", text or "")
    if not m:
        return [0, 0, 0, 0]
    try:
        return [float(x) for x in m.groups()]
    except ValueError:
        return [0, 0, 0, 0]


def paired_box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Reference cal_paired_ious math exactly (utils.py:59-85): clamped
    intersection, UNclamped areas (degenerate/inverted boxes keep their
    signed area), union + 1e-6."""
    x1 = np.maximum(a[:, 0], b[:, 0])
    y1 = np.maximum(a[:, 1], b[:, 1])
    x2 = np.minimum(a[:, 2], b[:, 2])
    y2 = np.minimum(a[:, 3], b[:, 3])
    inter = np.maximum(0, x2 - x1) * np.maximum(0, y2 - y1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a + area_b - inter + 1e-6)


def _gt_box(g) -> List[float]:
    """The gt side NEVER goes through the prediction extractor: the
    reference feeds raw lists (cal_cot_score.py:399-405 np.array(gt_resp));
    VisCoT gt boxes are normalized floats the int-only pattern would zero
    out. Strings (jsonl round-trips) parse via literal_eval; anything
    malformed or non-length-4 falls back to zeros instead of raising."""
    if isinstance(g, (list, tuple)) and len(g) == 4:
        return [float(x) for x in g]
    if isinstance(g, str):
        try:
            val = ast.literal_eval(g)
        except (ValueError, SyntaxError):
            return [0.0, 0.0, 0.0, 0.0]
        if isinstance(val, (list, tuple)) and len(val) == 4:
            return [float(x) for x in val]
    return [0.0, 0.0, 0.0, 0.0]


@SCORERS.register("one_box_iou05")
def one_box_iou05(queries, gt_resp, pred_resp, **kw) -> List[float]:
    pred = np.array([extract_one_bbox_from_str(p) for p in pred_resp], dtype=np.float64)
    gt = np.array([_gt_box(g) for g in gt_resp], dtype=np.float64)
    return (paired_box_iou(pred, gt) > 0.5).astype(float).tolist()


@SCORERS.register("llm")
def llm_judge(queries, gt_resp, pred_resp, client=None, **kw) -> List[float]:
    if client is None:
        raise ValueError("llm scorer needs client=LLMClient(...)")
    return client.score(queries, pred_resp, gt_resp)


@SCORERS.register("dummy_score")
def dummy_score(queries, gt_resp, pred_resp, **kw) -> List[float]:
    return [0.5] * len(queries)


def score_results(
    results_jsonl: str,
    scorer: str = "precise_match",
    batch_size: int = 16,
    client=None,
    overwrite: bool = False,
) -> Dict[str, Any]:
    """Score a results jsonl; resumes line-by-line via the _score file."""
    score_path = results_jsonl.replace(".jsonl", "_score.jsonl")
    done: Dict[Any, float] = {}
    if os.path.exists(score_path) and not overwrite:
        with open(score_path) as f:
            for line in f:
                rec = json.loads(line)
                done[rec["question_id"]] = rec["score"]

    with open(results_jsonl) as f:
        rows = [json.loads(line) for line in f]
    todo = [r for r in rows if r["question_id"] not in done]
    fn = SCORERS.get(scorer)

    mode = "a" if done and not overwrite else "w"
    with open(score_path, mode) as f:
        for start in range(0, len(todo), batch_size):
            batch = todo[start : start + batch_size]
            scores = fn(
                [r["query"] for r in batch],
                [r.get("answer") for r in batch],
                [r.get("response") for r in batch],
                client=client,
            )
            for r, s in zip(batch, scores):
                done[r["question_id"]] = float(s)
                f.write(json.dumps({"question_id": r["question_id"], "score": float(s)}) + "\n")

    summary = {
        "scorer": scorer,
        "num_scored": len(done),
        "mean_score": float(np.mean(list(done.values()))) if done else 0.0,
        "score_path": score_path,
    }
    with open(results_jsonl.replace(".jsonl", "_score_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary

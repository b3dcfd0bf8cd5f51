"""Short-form VQA scoring: the in-process replacement for the reference's
lmms-eval plugin (my_lmms_eval/, SURVEY.md §2.6).

Generic metric families live here (exact-match / yes-no / multiple-choice);
the per-benchmark OFFICIAL protocols and native file-format loaders for the
ten tasks the reference runs (eval_qwen_gp.sh:96-107) live in
evalsuite/protocols.py (MME category aggregation + acc+, MMBench
CircularEval, POPE subsets, GQA questions-dict, VQAv2 consensus accuracy)
and are dispatched via `score_task` below.

Counterpart of glimpseprune_tpu/evalsuite/shortform.py: the metrics,
``score_task`` and ``build_task_prompt`` are copies, and ``run_task`` drives
the port's ``GlimpsePruneRunner`` through the port's
``prepare_chat_inputs``; tests/test_torch_evalsuite.py holds them to JAX's.
"""

from __future__ import annotations

import re
import string
from typing import Dict, List, Optional, Sequence

import numpy as np

from glimpseprune_torch.evalsuite.scorers import _CHOICE_PATTERNS

_ARTICLES = {"a", "an", "the"}


def normalize_vqa_answer(text: str) -> str:
    """Lowercase, strip punctuation/articles, collapse whitespace (the usual
    VQA-v2 normalization)."""
    text = (text or "").lower().strip()
    text = text.translate(str.maketrans("", "", string.punctuation))
    words = [w for w in text.split() if w not in _ARTICLES]
    return " ".join(words)


def exact_match_accuracy(responses: Sequence[str], answers: Sequence[str]) -> float:
    hits = [
        normalize_vqa_answer(r) == normalize_vqa_answer(a)
        for r, a in zip(responses, answers)
    ]
    return float(np.mean(hits)) if hits else 0.0


def yes_no_metrics(responses: Sequence[str], answers: Sequence[str]) -> Dict[str, float]:
    """POPE-style: accuracy, precision, recall, F1 on the 'yes' class."""

    def to_label(t: str) -> Optional[bool]:
        t = (t or "").lower()
        if re.search(r"\byes\b", t):
            return True
        if re.search(r"\bno\b", t):
            return False
        return None

    tp = fp = fn = tn = 0
    correct = 0
    for r, a in zip(responses, answers):
        pr, gt = to_label(r), to_label(a)
        if pr is not None and pr == gt:
            correct += 1
        if gt is True and pr is True:
            tp += 1
        elif gt is False and pr is True:
            fp += 1
        elif gt is True and (pr is False or pr is None):
            fn += 1
        else:
            tn += 1
    n = max(len(responses), 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return {
        "accuracy": correct / n,
        "precision": precision,
        "recall": recall,
        "f1": 2 * precision * recall / max(precision + recall, 1e-9),
    }


def multiple_choice_accuracy(responses: Sequence[str], answers: Sequence[str]) -> float:
    hits = []
    for r, a in zip(responses, answers):
        a = (a or "").strip().upper()
        extracted = None
        for pat in _CHOICE_PATTERNS:
            m = re.search(pat, r or "", re.IGNORECASE)
            if m:
                extracted = m.group(1).upper()
                break
        hits.append(extracted == a)
    return float(np.mean(hits)) if hits else 0.0


TASK_METRICS = {
    "gqa": exact_match_accuracy,
    "vqav2": exact_match_accuracy,
    "vizwiz": exact_match_accuracy,
    "textvqa": exact_match_accuracy,
    "pope": yes_no_metrics,
    "mmbench": multiple_choice_accuracy,
    "seedbench": multiple_choice_accuracy,
    "scienceqa_img": multiple_choice_accuracy,
    "vstar": multiple_choice_accuracy,
}


def score_shortform(task: str, responses: Sequence[str], answers: Sequence[str]):
    try:
        fn = TASK_METRICS[task]
    except KeyError:
        raise KeyError(f"Unknown short-form task {task!r}; known: {sorted(TASK_METRICS)}")
    return fn(responses, answers)


def score_task(task: str, items):
    """Dispatch a benchmark's OFFICIAL protocol over its item records.

    task -> item type (see evalsuite/protocols.py): mme -> MMEItem,
    mmbench_* -> MMBenchItem, pope -> POPEItem, gqa -> GQAItem;
    vqav2/vizwiz take (response, [10 gt answers]) pairs; the remaining
    choice tasks take (response, answer-letter) pairs.
    """
    from glimpseprune_torch.evalsuite import protocols as P

    if task == "mme":
        return P.score_mme(items)
    if task.startswith("mmbench"):
        return P.score_mmbench(items)
    if task == "pope":
        return P.score_pope(items)
    if task == "gqa":
        return P.score_gqa(items)
    if task in ("vqav2", "vqav2_val_lite", "vizwiz", "vizwiz_vqa_val"):
        if items and isinstance(items[0], P.VQAOpenItem):
            return P.score_vqa_open(items)
        responses = [r for r, _ in items]
        gt = [a for _, a in items]
        return {"accuracy": P.vqav2_accuracy(responses, gt), "num": len(items)}
    if task == "seedbench":
        return P.score_seedbench(items)
    if task == "scienceqa_img":
        return P.score_scienceqa(items)
    if task in ("vstar", "vstar_bench"):
        return P.score_vstar(items)
    raise KeyError(f"Unknown benchmark task {task!r}")


# --------------------------------------------------------------------------- #
# Model-driven short-form runner
# --------------------------------------------------------------------------- #

# lmms-eval post-prompt conventions for the open-ended tasks (the reference
# runs these tasks through upstream lmms-eval's yamls; MME questions and
# V* `text` prompts already carry their instruction inline).
_SINGLE_WORD = "\nAnswer the question using a single word or phrase."
_VIZWIZ_POST = (
    "\nWhen the provided information is insufficient, respond with "
    "'Unanswerable'.\nAnswer the question using a single word or phrase."
)


def build_task_prompt(task: str, item) -> str:
    """The text (sans image marker) the model sees for one benchmark item —
    the per-task context construction the reference delegates to lmms-eval
    task yamls + my_lmms_eval/models/qwen2_5_vl_gp.py:337-356."""
    from glimpseprune_torch.evalsuite import protocols as P

    if task.startswith("mmbench"):
        return P.build_mmbench_prompt(item)
    if task == "seedbench":
        return P.build_seedbench_prompt(item)
    if task == "scienceqa_img":
        return P.build_scienceqa_prompt(item)
    if task in ("vstar", "vstar_bench"):
        return item.text            # options + instruction shipped inline
    if task == "mme":
        return item.question        # ends with "Please answer yes or no."
    if task == "pope":
        return item.question + _SINGLE_WORD
    if task == "gqa":
        return item.question + _SINGLE_WORD
    if task in ("vqav2", "vqav2_val_lite"):
        return item.question + _SINGLE_WORD
    if task in ("vizwiz", "vizwiz_vqa_val"):
        return item.question + _VIZWIZ_POST
    raise KeyError(f"Unknown benchmark task {task!r}")


def run_task(
    runner,
    task: str,
    items,
    tokenize,
    detokenize,
    load_image,
    max_new_tokens: int = 32,
    batch_size: int = 4,
    max_pixels: Optional[int] = None,
    generate_kwargs: Optional[Dict] = None,
):
    """Drive one short-form benchmark end-to-end: per-item chat prompt ->
    prepare_chat_inputs -> runner.generate -> detokenized responses written
    onto the items -> the task's OFFICIAL score (score_task).

    This is the in-process equivalent of the reference's lmms-eval loop
    (my_lmms_eval/models/qwen2_5_vl_gp.py:203-371: apply_chat_template over
    the task-built context, batched generate, postprocessed text per item).
    `load_image(item) -> np.ndarray` resolves each item's image; tokenize /
    detokenize are the model's text codec (framework stays tokenizer-
    agnostic).
    """
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_chat_inputs

    items = list(items)
    kwargs = dict(generate_kwargs or {})
    for start in range(0, len(items), batch_size):
        batch = items[start : start + batch_size]
        messages_list = [
            [{
                "role": "user",
                "content": [
                    {"type": "image"},
                    {"type": "text", "text": build_task_prompt(task, it)},
                ],
            }]
            for it in batch
        ]
        images = [load_image(it) for it in batch]
        prep = prepare_chat_inputs(
            runner.cfg, messages_list, images, tokenize, max_pixels=max_pixels
        )
        res = runner.generate(prep, max_new_tokens=max_new_tokens, **kwargs)
        for b, it in enumerate(batch):
            ids = res.sequences[b, : res.num_generated[b]]
            it.response = detokenize([int(x) for x in ids])
    return score_task(task, items)

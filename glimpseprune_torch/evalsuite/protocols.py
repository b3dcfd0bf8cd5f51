"""Per-benchmark short-form protocols + file-format loaders.

The reference runs ten lmms-eval tasks (scripts/eval_qwen_gp.sh:96-107:
vqav2_val_lite, gqa, vizwiz_vqa_val, scienceqa_img, pope, mme,
mmbench_en_test, mmbench_cn_test, seedbench, vstar_bench). lmms-eval is
torch/accelerate-entangled, so this module reimplements each task's official
scoring protocol and native file format directly:

- **MME**: per-category accuracy + acc+ (both questions of an image correct),
  category score = (acc + acc+) * 100, perception/cognition totals over the
  official category split. Loader for the official per-category txt layout.
- **MMBench**: option-letter extraction over (hint, question, A-D) prompts,
  CircularEval grouping — a base question counts only if every circular
  rotation (index offset by N*1e6 in the official TSV) is answered
  correctly. TSV loader.
- **POPE**: yes/no accuracy/precision/recall/F1 + yes-ratio, aggregated
  overall and per subset (random/popular/adversarial). jsonl loader
  ({question_id, text, label}).
- **GQA**: official questions-dict format ({qid: {question, answer,
  imageId}}), exact-match accuracy after VQA normalization.
- **VQAv2 / VizWiz**: official 10-annotator consensus accuracy
  min(#matches/3, 1) with the official answer normalization
  (contractions, digit words, articles, punctuation).
- **SEED-Bench**: official SEED-Bench.json loader (image subset), letter
  accuracy overall + per question_type dimension.
- **ScienceQA (img)**: official problems.json loader (image rows of a
  split), Context/Question/choices prompt, letter accuracy.
- **V-star**: jsonl loader ({text, label, category}), per-category accuracies
  (direct_attributes / relative_position) and their mean.

A copy of glimpseprune_tpu/evalsuite/protocols.py (numpy only);
tests/test_torch_evalsuite.py holds the two equal.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------- #
# VQA-v2 official answer normalization
# --------------------------------------------------------------------------- #

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hadnt": "hadn't", "hasnt": "hasn't", "havent": "haven't",
    "hed": "he'd", "hes": "he's", "howd": "how'd", "howll": "how'll",
    "hows": "how's", "im": "i'm", "ive": "i've", "isnt": "isn't",
    "itd": "it'd", "itll": "it'll", "lets": "let's", "maam": "ma'am",
    "mightve": "might've", "mustve": "must've", "shant": "shan't",
    "shed": "she'd", "shes": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "thats": "that's", "theres": "there's",
    "theyd": "they'd", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "wasnt": "wasn't", "wed": "we'd", "weve": "we've",
    "werent": "weren't", "whatll": "what'll", "whatre": "what're",
    "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't", "yall": "y'all",
    "youd": "you'd", "youll": "you'll", "youre": "you're", "youve": "you've",
}
_DIGIT_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
_ARTICLES = {"a", "an", "the"}
_PUNCT = list(";/[]\"{}()=+\\_-><@`,?!") + ["'"]
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")


def _process_punctuation(text: str) -> str:
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or (
            _COMMA_STRIP.search(text) is not None
        ):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out)
    return out


def _process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = _DIGIT_MAP.get(word, word)
        if word not in _ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in _CONTRACTIONS:
            out[i] = _CONTRACTIONS[word]
    return " ".join(out)


def vqa_normalize(text: str) -> str:
    """The official VQA-v2 evaluation normalization (punctuation strip,
    digit-word mapping, article removal, contraction restoration)."""
    text = (text or "").replace("\n", " ").replace("\t", " ").strip()
    return _process_digit_article(_process_punctuation(text))


def vqav2_accuracy(
    responses: Sequence[str],
    gt_answers: Sequence[Sequence[str]],
) -> float:
    """Official consensus accuracy: each question has 10 human answers;
    acc = mean over leave-one-out splits = min(#matches / 3, 1)."""
    accs = []
    for resp, answers in zip(responses, gt_answers):
        r = vqa_normalize(resp)
        ans = [vqa_normalize(a) for a in answers]
        if len(ans) >= 10:
            # official leave-one-annotator-out averaging
            per = []
            for i in range(len(ans)):
                others = ans[:i] + ans[i + 1 :]
                per.append(min(sum(a == r for a in others) / 3.0, 1.0))
            accs.append(float(np.mean(per)))
        else:
            accs.append(min(sum(a == r for a in ans) / 3.0, 1.0))
    return float(np.mean(accs)) if accs else 0.0


# --------------------------------------------------------------------------- #
# MME
# --------------------------------------------------------------------------- #

MME_PERCEPTION_CATEGORIES = (
    "existence", "count", "position", "color", "posters", "celebrity",
    "scene", "landmark", "artwork", "OCR",
)
MME_COGNITION_CATEGORIES = (
    "commonsense_reasoning", "numerical_calculation", "text_translation",
    "code_reasoning",
)


@dataclass
class MMEItem:
    image_id: str
    category: str
    question: str
    answer: str                      # "Yes" / "No"
    response: Optional[str] = None


def load_mme_dir(root: str) -> List[MMEItem]:
    """Official MME layout: <root>/<category>/ holds either per-image ``.txt``
    files (two lines, each "question\\tanswer") next to the images, or a
    ``questions_answers_YN/`` subfolder with those txts."""
    items: List[MMEItem] = []
    for cat in sorted(os.listdir(root)):
        cdir = os.path.join(root, cat)
        if not os.path.isdir(cdir):
            continue
        qa_dir = os.path.join(cdir, "questions_answers_YN")
        scan = qa_dir if os.path.isdir(qa_dir) else cdir
        for fn in sorted(os.listdir(scan)):
            if not fn.endswith(".txt"):
                continue
            with open(os.path.join(scan, fn)) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    q, _, a = line.partition("\t")
                    items.append(MMEItem(
                        image_id=os.path.splitext(fn)[0],
                        category=cat, question=q, answer=a.strip(),
                    ))
    return items


def _mme_label(text: str) -> Optional[bool]:
    t = (text or "").lower()
    if re.search(r"\byes\b", t):
        return True
    if re.search(r"\bno\b", t):
        return False
    return None


def score_mme(items: Sequence[MMEItem]) -> Dict[str, Any]:
    """Official MME aggregation: per category acc (per question), acc+ (both
    questions of an image right), score = (acc + acc+) * 100; perception /
    cognition totals sum their categories' scores."""
    by_cat: Dict[str, List[MMEItem]] = {}
    for it in items:
        by_cat.setdefault(it.category, []).append(it)

    out: Dict[str, Any] = {"categories": {}}
    perception = cognition = 0.0
    for cat, cat_items in sorted(by_cat.items()):
        correct = 0
        by_img: Dict[str, List[bool]] = {}
        for it in cat_items:
            ok = (
                _mme_label(it.response) is not None
                and _mme_label(it.response) == _mme_label(it.answer)
            )
            correct += int(ok)
            by_img.setdefault(it.image_id, []).append(ok)
        acc = correct / max(len(cat_items), 1)
        acc_plus = float(np.mean([all(v) for v in by_img.values()])) if by_img else 0.0
        score = (acc + acc_plus) * 100.0
        out["categories"][cat] = {
            "acc": acc, "acc_plus": acc_plus, "score": score,
            "num_questions": len(cat_items), "num_images": len(by_img),
        }
        if cat in MME_PERCEPTION_CATEGORIES:
            perception += score
        elif cat in MME_COGNITION_CATEGORIES:
            cognition += score
    out["perception_score"] = perception
    out["cognition_score"] = cognition
    return out


# --------------------------------------------------------------------------- #
# MMBench
# --------------------------------------------------------------------------- #

MMBENCH_CIRCULAR_BASE = 1_000_000
MMBENCH_OPTION_KEYS = ("A", "B", "C", "D")


@dataclass
class MMBenchItem:
    index: int
    question: str
    options: Dict[str, str]          # letter -> text (missing letters absent)
    answer: Optional[str] = None     # gt letter (None on the hidden test set)
    hint: str = ""
    category: str = ""
    response: Optional[str] = None


def load_mmbench_tsv(path: str) -> List[MMBenchItem]:
    """Official MMBench TSV (columns: index, question, hint, A, B, C, D,
    answer, category, ...). Uses csv with tab dialect — option texts may
    contain commas."""
    import csv

    items: List[MMBenchItem] = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            options = {
                k: row[k].strip()
                for k in MMBENCH_OPTION_KEYS
                if row.get(k) and row[k].strip() and row[k].strip() != "nan"
            }
            items.append(MMBenchItem(
                index=int(row["index"]),
                question=row.get("question", ""),
                options=options,
                answer=(row.get("answer") or "").strip() or None,
                hint=(row.get("hint") or "").strip(),
                category=(row.get("category") or "").strip(),
            ))
    return items


def build_mmbench_prompt(item: MMBenchItem) -> str:
    """lmms-eval mmbench prompt: hint, question, lettered options, then the
    direct-letter instruction."""
    parts = []
    if item.hint and item.hint.lower() != "nan":
        parts.append(item.hint)
    parts.append(item.question)
    for k in MMBENCH_OPTION_KEYS:
        if k in item.options:
            parts.append(f"{k}. {item.options[k]}")
    parts.append("Answer with the option's letter from the given choices directly.")
    return "\n".join(parts)


def extract_choice_letter(response: str, options: Dict[str, str]) -> Optional[str]:
    """Letter extraction: leading letter, '(X)', 'X.', or a unique option-text
    substring match."""
    r = (response or "").strip()
    m = re.match(r"^\(?([A-D])\)?(?:[\s.,:)]|$)", r, re.IGNORECASE)
    if m:
        return m.group(1).upper()
    m = re.search(r"\b(?:answer|option)\s*(?:is|:)?\s*\(?([A-D])\)?", r, re.IGNORECASE)
    if m:
        return m.group(1).upper()
    hits = [k for k, v in options.items() if v and v.lower() in r.lower()]
    if len(hits) == 1:
        return hits[0]
    return None


def score_mmbench(items: Sequence[MMBenchItem]) -> Dict[str, Any]:
    """CircularEval: group rotations by index % 1e6; a base question is
    correct only if EVERY rotation's extracted letter matches its gt."""
    groups: Dict[int, List[MMBenchItem]] = {}
    for it in items:
        groups.setdefault(it.index % MMBENCH_CIRCULAR_BASE, []).append(it)

    n_correct = 0
    per_category: Dict[str, List[bool]] = {}
    for base, rotations in groups.items():
        ok = all(
            it.answer is not None
            and extract_choice_letter(it.response or "", it.options) == it.answer
            for it in rotations
        )
        n_correct += int(ok)
        cat = rotations[0].category or "overall"
        per_category.setdefault(cat, []).append(ok)
    n = max(len(groups), 1)
    return {
        "accuracy": n_correct / n,
        "num_questions": len(groups),
        "num_rows": len(items),
        "categories": {
            c: float(np.mean(v)) for c, v in sorted(per_category.items())
        },
    }


# --------------------------------------------------------------------------- #
# POPE
# --------------------------------------------------------------------------- #


@dataclass
class POPEItem:
    question_id: Any
    question: str
    label: str                       # "yes" / "no"
    subset: str = "adversarial"      # random / popular / adversarial
    response: Optional[str] = None


def load_pope_jsonl(path: str, subset: Optional[str] = None) -> List[POPEItem]:
    """Official POPE jsonl: {"question_id", "image", "text", "label"}; the
    subset is conventionally encoded in the filename
    (coco_pope_adversarial.json etc.)."""
    if subset is None:
        base = os.path.basename(path)
        m = re.search(r"(random|popular|adversarial)", base)
        subset = m.group(1) if m else "unknown"
    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            items.append(POPEItem(
                question_id=row.get("question_id"),
                question=row.get("text", row.get("question", "")),
                label=row["label"],
                subset=subset,
            ))
    return items


def score_pope(items: Sequence[POPEItem]) -> Dict[str, Any]:
    """Accuracy / precision / recall / F1 on the 'yes' class + yes-ratio,
    overall and per subset (the lmms-eval pope metric set)."""
    from glimpseprune_torch.evalsuite.shortform import yes_no_metrics

    def agg(sub: Sequence[POPEItem]) -> Dict[str, float]:
        m = yes_no_metrics([i.response or "" for i in sub], [i.label for i in sub])
        yes = sum(
            1 for i in sub if re.search(r"\byes\b", (i.response or "").lower())
        )
        m["yes_ratio"] = yes / max(len(sub), 1)
        return m

    out: Dict[str, Any] = dict(agg(items))
    subsets = sorted({i.subset for i in items})
    if len(subsets) > 1:
        out["subsets"] = {s: agg([i for i in items if i.subset == s]) for s in subsets}
    return out


# --------------------------------------------------------------------------- #
# GQA
# --------------------------------------------------------------------------- #


@dataclass
class GQAItem:
    question_id: str
    question: str
    answer: str
    image_id: str = ""
    full_answer: str = ""
    response: Optional[str] = None


def load_gqa_questions(path: str) -> List[GQAItem]:
    """Official GQA format: one json dict {qid: {question, answer, imageId,
    fullAnswer, ...}} (val_balanced_questions.json et al)."""
    with open(path) as f:
        data = json.load(f)
    items = []
    for qid, row in data.items():
        items.append(GQAItem(
            question_id=qid,
            question=row["question"],
            answer=row.get("answer", ""),
            image_id=row.get("imageId", ""),
            full_answer=row.get("fullAnswer", ""),
        ))
    items.sort(key=lambda x: x.question_id)
    return items


def score_gqa(items: Sequence[GQAItem]) -> Dict[str, float]:
    hits = [
        vqa_normalize(i.response or "") == vqa_normalize(i.answer) for i in items
    ]
    return {"accuracy": float(np.mean(hits)) if hits else 0.0, "num": len(items)}


# --------------------------------------------------------------------------- #
# SEED-Bench
# --------------------------------------------------------------------------- #


@dataclass
class SeedBenchItem:
    question_id: Any
    question: str
    options: Dict[str, str]          # letter -> choice text
    answer: str                      # gt letter
    question_type_id: int = 0
    question_type: str = ""          # resolved dimension name
    data_id: str = ""                # image filename
    response: Optional[str] = None


def load_seedbench_json(path: str, image_only: bool = True) -> List[SeedBenchItem]:
    """Official SEED-Bench.json: {"questions": [{question, choice_a..choice_d,
    answer, question_id, question_type_id, data_id, data_type}, ...],
    "question_type": {name: id}}. The reference's `seedbench` lmms-eval task
    evaluates the image subset (data_type == "image"); question_type_id maps
    to a dimension name for the official per-dimension aggregation."""
    with open(path) as f:
        data = json.load(f)
    type_by_id = {v: k for k, v in data.get("question_type", {}).items()}
    items = []
    for q in data["questions"]:
        if image_only and q.get("data_type", "image") != "image":
            continue
        options = {}
        for i, key in enumerate(("choice_a", "choice_b", "choice_c", "choice_d")):
            if q.get(key) is not None:
                options[chr(ord("A") + i)] = str(q[key])
        tid = int(q.get("question_type_id", 0))
        items.append(SeedBenchItem(
            question_id=q.get("question_id"),
            question=q.get("question", ""),
            options=options,
            answer=str(q.get("answer", "")).strip().upper(),
            question_type_id=tid,
            question_type=type_by_id.get(tid, str(tid)),
            data_id=str(q.get("data_id", "")),
        ))
    return items


def build_seedbench_prompt(item: SeedBenchItem) -> str:
    """lmms-eval seedbench prompt: question, lettered choices, direct-letter
    instruction."""
    parts = [item.question]
    for k in sorted(item.options):
        parts.append(f"{k}. {item.options[k]}")
    parts.append("Answer with the option's letter from the given choices directly.")
    return "\n".join(parts)


def score_seedbench(items: Sequence[SeedBenchItem]) -> Dict[str, Any]:
    """Overall accuracy + the official per-dimension (question_type) split."""
    per_dim: Dict[str, List[bool]] = {}
    hits = []
    for it in items:
        ok = extract_choice_letter(it.response or "", it.options) == it.answer
        hits.append(ok)
        per_dim.setdefault(it.question_type or "unknown", []).append(ok)
    return {
        "accuracy": float(np.mean(hits)) if hits else 0.0,
        "num": len(items),
        "dimensions": {d: float(np.mean(v)) for d, v in sorted(per_dim.items())},
    }


# --------------------------------------------------------------------------- #
# ScienceQA (image subset)
# --------------------------------------------------------------------------- #


@dataclass
class ScienceQAItem:
    question_id: str
    question: str
    options: Dict[str, str]          # letter -> choice text
    answer: str                      # gt letter (chr(65 + answer index))
    hint: str = ""
    image: Optional[str] = None      # image filename (None = text-only row)
    split: str = "test"
    response: Optional[str] = None


def load_scienceqa_problems(
    path: str, split: Optional[str] = "test", image_only: bool = True
) -> List[ScienceQAItem]:
    """Official ScienceQA problems.json: {qid: {question, choices: [str],
    answer: int, hint, image, split, ...}}. scienceqa_img keeps only rows
    with an image in the requested split; the int answer index becomes the
    gt letter."""
    with open(path) as f:
        data = json.load(f)
    items = []
    for qid, row in data.items():
        if split is not None and row.get("split") != split:
            continue
        if image_only and not row.get("image"):
            continue
        options = {
            chr(ord("A") + i): str(c) for i, c in enumerate(row.get("choices", []))
        }
        items.append(ScienceQAItem(
            question_id=str(qid),
            question=row.get("question", ""),
            options=options,
            answer=chr(ord("A") + int(row.get("answer", 0))),
            hint=(row.get("hint") or "").strip(),
            image=row.get("image"),
            split=row.get("split", ""),
        ))
    items.sort(key=lambda x: x.question_id)
    return items


def build_scienceqa_prompt(item: ScienceQAItem) -> str:
    """lmms-eval scienceqa_img prompt: optional context (hint), question,
    lettered choices, direct-letter instruction."""
    parts = []
    if item.hint:
        parts.append(f"Context: {item.hint}")
    parts.append(f"Question: {item.question}")
    for k in sorted(item.options):
        parts.append(f"{k}. {item.options[k]}")
    parts.append("Answer with the option's letter from the given choices directly.")
    return "\n".join(parts)


def score_scienceqa(items: Sequence[ScienceQAItem]) -> Dict[str, Any]:
    hits = [
        extract_choice_letter(it.response or "", it.options) == it.answer
        for it in items
    ]
    return {"accuracy": float(np.mean(hits)) if hits else 0.0, "num": len(items)}


# --------------------------------------------------------------------------- #
# V* Bench
# --------------------------------------------------------------------------- #


@dataclass
class VStarItem:
    question_id: Any
    text: str                        # full prompt (question + options), as shipped
    options: Dict[str, str]          # letter -> option text (parsed from `text`)
    label: str                       # gt letter
    category: str = ""               # direct_attributes / relative_position
    image: str = ""
    response: Optional[str] = None


_VSTAR_OPTION_RE = re.compile(r"^\(?([A-D])[\).]\s*(.+)$")


def load_vstar_jsonl(path: str) -> List[VStarItem]:
    """vstar_bench rows ({question_id, image, text, label, category}, one
    json object per line or a json list): `text` is the full prompt with the
    lettered options inlined; `label` is the gt letter; `category` is the
    official split (direct_attributes / relative_position). Option texts are
    parsed back out of `text` for letter extraction."""
    with open(path) as f:
        head = f.read().strip()
    rows = json.loads(head) if head.startswith("[") else [
        json.loads(line) for line in head.splitlines() if line.strip()
    ]
    items = []
    for row in rows:
        options: Dict[str, str] = {}
        for line in str(row.get("text", "")).splitlines():
            m = _VSTAR_OPTION_RE.match(line.strip())
            if m:
                options[m.group(1).upper()] = m.group(2).strip()
        items.append(VStarItem(
            question_id=row.get("question_id"),
            text=row.get("text", ""),
            options=options,
            label=str(row.get("label", "")).strip().upper(),
            category=row.get("category", ""),
            image=row.get("image", ""),
        ))
    return items


def score_vstar(items: Sequence[VStarItem]) -> Dict[str, Any]:
    """Per-category accuracy + their mean (the official V* aggregation
    averages the two category accuracies)."""
    per_cat: Dict[str, List[bool]] = {}
    for it in items:
        ok = extract_choice_letter(it.response or "", it.options) == it.label
        per_cat.setdefault(it.category or "overall", []).append(ok)
    cats = {c: float(np.mean(v)) for c, v in sorted(per_cat.items())}
    return {
        "accuracy": float(np.mean(list(cats.values()))) if cats else 0.0,
        "num": len(items),
        "categories": cats,
    }


# --------------------------------------------------------------------------- #
# VQAv2 / VizWiz (open-ended, 10-annotator consensus)
# --------------------------------------------------------------------------- #


@dataclass
class VQAOpenItem:
    question_id: Any
    question: str
    answers: List[str]               # the 10 annotator answers
    image_id: Any = ""
    response: Optional[str] = None


def load_vqav2_questions(
    questions_path: str, annotations_path: Optional[str] = None
) -> List[VQAOpenItem]:
    """Official VQA-v2 file pair: questions json
    {"questions": [{question_id, image_id, question}]} joined with
    annotations json {"annotations": [{question_id, answers:
    [{answer, ...} x10]}]} on question_id. Without annotations (test split)
    `answers` is empty and only responses can be produced, not scored."""
    with open(questions_path) as f:
        qdata = json.load(f)
    ann_by_qid: Dict[Any, List[str]] = {}
    if annotations_path:
        with open(annotations_path) as f:
            adata = json.load(f)
        for a in adata.get("annotations", []):
            ann_by_qid[a["question_id"]] = [x["answer"] for x in a.get("answers", [])]
    items = []
    for q in qdata.get("questions", []):
        qid = q["question_id"]
        items.append(VQAOpenItem(
            question_id=qid,
            question=q.get("question", ""),
            answers=ann_by_qid.get(qid, []),
            image_id=q.get("image_id", ""),
        ))
    return items


def load_vizwiz_annotations(path: str) -> List[VQAOpenItem]:
    """Official VizWiz val/train json: a list of {image, question,
    answers: [{answer, answer_confidence} x10], answerable}. The image
    filename doubles as the question id."""
    with open(path) as f:
        rows = json.load(f)
    return [
        VQAOpenItem(
            question_id=row.get("image", ""),
            question=row.get("question", ""),
            answers=[a["answer"] for a in row.get("answers", [])],
            image_id=row.get("image", ""),
        )
        for row in rows
    ]


def score_vqa_open(items: Sequence[VQAOpenItem]) -> Dict[str, Any]:
    """Official consensus accuracy min(#matching annotators / 3, 1) averaged
    over items (see vqav2_accuracy for the per-item normalization rules)."""
    responses = [it.response or "" for it in items]
    gt = [it.answers for it in items]
    return {"accuracy": vqav2_accuracy(responses, gt), "num": len(items)}

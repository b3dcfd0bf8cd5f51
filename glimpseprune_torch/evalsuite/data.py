"""Benchmark data loading: VisCoT-format JSONs + mapper registry.

Counterpart of glimpseprune_tpu/evalsuite/data.py (format parity with the
reference benchmarks viscot_benchmark/benchmark/*.json; mapper semantics
viscot_eval/infer_cot.py:223-287): each sample carries a query, an image
path, an optional ground-truth bbox (normalized xyxy), and the reference
answer. Images may be ``.npy`` arrays [H, W, 3] uint8, read with numpy;
PIL is imported only for other files (``load_image``, ``read_image_size``).
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from glimpseprune_torch.registry import Registry

DATASET_MAPPERS: Registry = Registry("dataset_mapper")

COT_BRIEF_PROMPT = "{}\nAnswer the question using a single word or phrase."
CHOICE_BRIEF_PROMPT = " Answer with the option's letter from the given choices directly."


def load_image(path: str) -> np.ndarray:
    """An image file -> [H, W, 3] uint8: ``.npy`` through numpy, any other
    format through PIL (imported here only)."""
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_image_size(path: str) -> Tuple[int, int]:
    """(width, height) of an image file, without decoding a ``.npy``."""
    if path.endswith(".npy"):
        h, w = np.load(path, mmap_mode="r").shape[:2]
        return int(w), int(h)
    from PIL import Image

    with Image.open(path) as im:
        return im.size


@dataclass
class EvalSample:
    sample_id: Any
    query: str
    img_path: str
    answer: Optional[str] = None
    normed_bboxes: Optional[List[List[float]]] = None
    raw: Dict[str, Any] = field(default_factory=dict)


def norm_bbox(bbox, width, height):
    x1, y1, x2, y2 = bbox
    return [x1 / width, y1 / height, x2 / width, y2 / height]


@DATASET_MAPPERS.register("cot_bench")
def cot_bench_mapper(one: Dict[str, Any], img_dir: str, brief: bool = True,
                     use_box: bool = True, image_size=None) -> EvalSample:
    """VisCoT benchmark row -> sample (reference cot_bench_dataset_mapper)."""
    query = (
        one["conversations"][0]["value"]
        .replace(
            "Please provide the bounding box coordinate of the region that can help you answer the question better.",
            "",
        )
        .strip()
        .replace("<image>\n", "")
    )
    if brief:
        query = COT_BRIEF_PROMPT.format(query)
    img_path = os.path.join(img_dir, one["image"][0])
    if not os.path.isfile(img_path):
        # reference fallback: some datasets store images under a val/
        # subfolder (infer_cot.py:233-236 inserts "val" at component 3)
        parts = img_path.split("/")
        if len(parts) > 3:
            alt = os.path.join(*parts[:3], "val", *parts[3:])
            if img_path.startswith("/"):
                alt = "/" + alt
            if os.path.isfile(alt):
                img_path = alt
    bboxes = None
    if use_box and len(one.get("image", [])) > 1 and "###" in one["image"][1]:
        bbox = ast.literal_eval(one["image"][1].split("###")[1])
        w, h = image_size if image_size is not None else read_image_size(img_path)
        bboxes = [norm_bbox(bbox, w, h)]
    answer = one["conversations"][-1]["value"] if one.get("conversations") else None
    return EvalSample(
        sample_id=one.get("question_id", one.get("id")),
        query=query,
        img_path=img_path,
        answer=answer,
        normed_bboxes=bboxes,
        raw=one,
    )


@DATASET_MAPPERS.register("vstar")
def vstar_mapper(one: Dict[str, Any], img_dir: str, brief: bool = True,
                 use_box: bool = False, image_size=None) -> EvalSample:
    query = one["text"]
    if not brief:
        query = query.replace(CHOICE_BRIEF_PROMPT, "")
    return EvalSample(
        sample_id=one.get("question_id", one.get("id")),
        query=query,
        img_path=os.path.join(img_dir, one["image"]),
        answer=one.get("label"),
        raw=one,
    )


@DATASET_MAPPERS.register("refcoco")
def refcoco_mapper(one: Dict[str, Any], img_dir: str, brief: bool = True,
                   use_box: bool = True, image_size=None) -> EvalSample:
    bboxes = None
    if use_box and "normalized_solution" in one:
        bboxes = [[d / 1000.0 for d in one["normalized_solution"]]]
    return EvalSample(
        sample_id=one.get("id"),
        query=one["problem"] + " Output the final answer in JSON format.",
        img_path=os.path.join(img_dir, one["image"]),
        answer=str(one.get("solution", "")),
        normed_bboxes=bboxes,
        raw=one,
    )


def load_benchmark(
    json_path: str,
    img_dir: str,
    mapper: str = "cot_bench",
    brief: bool = True,
    use_box: bool = True,
    num_samples: Optional[int] = None,
    image_size=None,
) -> List[EvalSample]:
    with open(json_path) as f:
        data = json.load(f)
    if num_samples is not None:
        data = data[:num_samples]
    fn = DATASET_MAPPERS.get(mapper)
    return [fn(d, img_dir, brief=brief, use_box=use_box, image_size=image_size) for d in data]


def shard_for_host(samples: Sequence, host_id: int, num_hosts: int) -> List:
    """Contiguous per-host slices (reference rank sharding
    infer_cot.py:468-471)."""
    n = len(samples)
    per = (n + num_hosts - 1) // num_hosts
    return list(samples[host_id * per : (host_id + 1) * per])

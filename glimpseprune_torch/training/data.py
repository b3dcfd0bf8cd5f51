"""Training data pipeline: YAML multi-dataset, mappers, filters, sampling.

Counterpart of glimpseprune_tpu/training/data.py (reference
train_qwen_gp.py:91-219 mappers and filters, :350-596 GPDataset): per-entry
json_path, sampling_strategy (first:N / end:N / random:N with a seed), a
mapper plus additional mappers, an optional prompt template and per-entry
score_funcs; the entries concatenate into one dataset. Train rows are
VisCoT-style jsonl: {question, answer, image, width, height, bboxs,
dataset, split}. Host-side Python and numpy only; ``yaml`` is imported only
when a config is given as a path. ``RepeatRandomSampler`` is the GRPO
batches' G-repeat order.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from glimpseprune_torch.registry import Registry

TRAIN_MAPPERS: Registry = Registry("train_mapper")
TRAIN_FILTERS: Registry = Registry("train_filter")


@dataclass
class TrainSample:
    query: str
    answer: str
    img_path: str
    normed_bboxes: Optional[List[List[float]]] = None
    score_funcs: List[str] = field(default_factory=list)
    full_mask: bool = False
    raw: Dict[str, Any] = field(default_factory=dict)


@TRAIN_MAPPERS.register("cot_train")
def cot_train_mapper(one: Dict[str, Any], img_dir: str = "", prompt: Optional[str] = None,
                     score_funcs=(), **kw) -> TrainSample:
    query = one["question"]
    if prompt:
        query = prompt.format(query)
    return TrainSample(
        query=query,
        answer=one["answer"],
        img_path=os.path.join(img_dir, "cot", one["dataset"], one["image"]),
        normed_bboxes=[list(b) for b in one.get("bboxs", [])] or None,
        score_funcs=list(score_funcs),
        raw=one,
    )


@TRAIN_MAPPERS.register("cot_train_fullmask")
def cot_train_fullmask_mapper(one, **kw) -> TrainSample:
    """The same rows, with a supervision mask over the whole image."""
    s = cot_train_mapper(one, **kw)
    s.normed_bboxes = [[0.0, 0.0, 1.0, 1.0]]
    s.full_mask = True
    return s


@TRAIN_MAPPERS.register("norm_bboxes")
def norm_bboxes_mapper(sample: TrainSample, bbox_type: str = "xyxy", **kw) -> TrainSample:
    """Pixel xyxy / xywh or norm1000 boxes -> normalized [0, 1] xyxy."""
    if sample.normed_bboxes is None:
        return sample
    w, h = sample.raw.get("width"), sample.raw.get("height")
    out = []
    for x1, y1, x2, y2 in sample.normed_bboxes:
        if bbox_type == "xywh":
            x2, y2 = x1 + x2, y1 + y2
        if bbox_type == "norm1000":
            out.append([x1 / 1000.0, y1 / 1000.0, x2 / 1000.0, y2 / 1000.0])
        else:
            if not (w and h):
                raise ValueError("pixel bboxes need width and height in the row")
            out.append([x1 / w, y1 / h, x2 / w, y2 / h])
    sample.normed_bboxes = [[min(max(v, 0.0), 1.0) for v in b] for b in out]
    return sample


@TRAIN_FILTERS.register("image_exist")
def image_exist_filter(sample: TrainSample, **kw) -> bool:
    return os.path.isfile(sample.img_path)


@TRAIN_FILTERS.register("inputs_seq_length")
def inputs_seq_length_filter(sample: TrainSample,
                             tokenize: Optional[Callable[[str], List[int]]] = None,
                             max_input_seq_length: Optional[int] = None,
                             max_image_tokens: Optional[int] = None, factor: int = 28,
                             max_pixels: Optional[int] = None, **kw) -> bool:
    """Drop rows whose prompt would exceed the sequence budget; the image
    token count comes from the smart_resize geometry, without pixels."""
    from glimpseprune_torch.preprocessing.image import DEFAULT_MAX_PIXELS, smart_resize

    w, h = sample.raw.get("width"), sample.raw.get("height")
    n_img = 0
    if w and h:
        rh, rw = smart_resize(h, w, factor, max_pixels=max_pixels or DEFAULT_MAX_PIXELS)
        n_img = (rh // factor) * (rw // factor)
    if max_image_tokens is not None and n_img > max_image_tokens:
        return False
    if max_input_seq_length is not None:
        n_text = len(tokenize(sample.query + " " + sample.answer)) if tokenize else 0
        if n_text + n_img > max_input_seq_length:
            return False
    return True


def _apply_sampling(rows: List[Any], strategy: Optional[str], seed: int) -> List[Any]:
    """first:N / end:N / random:N."""
    if not strategy:
        return rows
    kind, _, num = strategy.partition(":")
    n = int(num)
    if kind == "first":
        return rows[:n]
    if kind == "end":
        return rows[-n:]
    if kind == "random":
        if n >= len(rows):
            return list(rows)
        return random.Random(seed).sample(rows, n)
    raise ValueError(f"Unknown sampling strategy {strategy!r}")


class GPDataset:
    """A concatenation of jsonl shards with mappers and filters, from a
    YAML path or an already-parsed dict."""

    def __init__(self, config: Any, img_dir: str = "", tokenize: Optional[Callable] = None,
                 filters: Sequence[str] = ("image_exist",),
                 filter_kwargs: Optional[Dict[str, Any]] = None,
                 skip_missing_images: bool = True):
        if isinstance(config, str):
            import yaml

            with open(config) as f:
                config = yaml.safe_load(f)
        self.samples: List[TrainSample] = []
        fkw = dict(filter_kwargs or {})
        fkw.setdefault("tokenize", tokenize)
        for entry in config["datasets"]:
            with open(entry["json_path"]) as f:
                rows = [json.loads(line) for line in f if line.strip()]
            rows = _apply_sampling(rows, entry.get("sampling_strategy"),
                                   entry.get("sampling_seed", 42))
            mapper = TRAIN_MAPPERS.get(entry.get("mapper", "cot_train"))
            extra = [TRAIN_MAPPERS.get(m) for m in entry.get("additional_mappers", [])]
            for row in rows:
                s = mapper(row, img_dir=img_dir, prompt=entry.get("prompt"),
                           score_funcs=entry.get("score_funcs", []))
                for em in extra:
                    s = em(s, bbox_type=entry.get("bbox_type", "xyxy"))
                if all(TRAIN_FILTERS.get(name)(s, **fkw) for name in filters
                       if skip_missing_images or name != "image_exist"):
                    self.samples.append(s)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True) -> Iterator[List[TrainSample]]:
        """Batches of samples in the order of numpy's default_rng(seed)
        shuffle, as the JAX pipeline draws them."""
        idx = np.arange(len(self.samples))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
        for start in range(0, end, batch_size):
            yield [self.samples[i] for i in idx[start:start + batch_size]]


class RepeatRandomSampler:
    """G-repeat sampling for GRPO batches (JAX data.py:202-219, reference
    train_qwen_gp.py:665-712): the indices in an order shuffled by
    ``np.random.default_rng(seed)``, each ``num_repeats`` times in a row."""

    def __init__(self, n: int, num_repeats: int, seed: int = 0):
        self.n = n
        self.num_repeats = num_repeats
        self.seed = seed

    def __iter__(self) -> Iterator[int]:
        idx = np.arange(self.n)
        np.random.default_rng(self.seed).shuffle(idx)
        for i in idx:
            for _ in range(self.num_repeats):
                yield int(i)

    def __len__(self) -> int:
        return self.n * self.num_repeats

"""Free-form inference harness: generate / glimpse tasks -> jsonl + info.json.

Counterpart of glimpseprune_tpu/evalsuite/infer.py (artifact and metric
parity with the reference harness viscot_eval/infer_cot.py): per-sample
response + generated-token count, mask confusion-matrix/IoU/retention vs
bbox ground truth, dataset-level info.json with args, average wall-clock
per call, and the profiling stats of the runner's decorated methods;
idempotent skip-if-done resume. It drives the port's
``GlimpsePruneRunner``; the records' fields and the info's keys are the
JAX harness's.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from glimpseprune_torch.evalsuite.data import EvalSample
from glimpseprune_torch.evalsuite.data import load_image as default_load_image
from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
from glimpseprune_torch.utils.profiling import (
    LoggerControl,
    get_logger_stats,
    reset_logger_stats,
)


@dataclass
class InferenceConfig:
    task: str = "generate"            # "generate" | "glimpse"
    batch_size: int = 1
    max_new_tokens: int = 1024
    use_ref_masks: bool = False
    do_selection: bool = True
    brief: bool = True
    save_masks: bool = False
    max_pixels: Optional[int] = None
    # run a baseline compressor instead of GP (visionzip / divprune /
    # cdpruner / pdrop / vscan); task must be "generate"
    compressor: Optional[str] = None
    compressor_kwargs: Dict[str, Any] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)


def cal_box_metrics(keep_mask: np.ndarray, ref_mask: Optional[np.ndarray],
                    n_tokens: int) -> Dict[str, Any]:
    """Mask-vs-bbox confusion matrix + IoU + retention ratio
    (reference infer_cot.py:350-373)."""
    keep = keep_mask[:n_tokens].astype(bool)
    out = {"mask_ratio": float(keep.mean()) if n_tokens else 0.0}
    if ref_mask is not None:
        ref = ref_mask[:n_tokens].astype(bool)
        tp = int((keep & ref).sum())
        fp = int((keep & ~ref).sum())
        fn = int((~keep & ref).sum())
        tn = int((~keep & ~ref).sum())
        out.update(
            tp=tp, fp=fp, fn=fn, tn=tn,
            iou=tp / max(tp + fp + fn, 1),
            precision=tp / max(tp + fp, 1),
            recall=tp / max(tp + fn, 1),
        )
    return out


def _responses(res, n: int, detokenize) -> List[str]:
    return [detokenize([int(x) for x in res.sequences[b, : res.num_generated[b]]])
            for b in range(n)]


def run_inference(
    runner,
    samples: Sequence[EvalSample],
    out_dir: str,
    dataset_name: str,
    cfg: InferenceConfig,
    tokenize: Callable[[str], List[int]],
    detokenize: Callable[[Sequence[int]], str],
    build_prompt: Optional[Callable[[str], List[int]]] = None,
    load_image: Optional[Callable[[str], np.ndarray]] = None,
    overwrite: bool = False,
) -> str:
    """Run one dataset through ``runner`` (a ``GlimpsePruneRunner``);
    returns the output jsonl path.

    tokenize/detokenize: the model's tokenizer (the harness stays tokenizer-
    agnostic). build_prompt: query text -> full prompt ids including exactly
    one image marker; defaults to the image marker between vision start/end
    tokens, then ``tokenize(query)``. load_image: path -> [H, W, 3] uint8
    (default ``data.load_image``: ``.npy`` by numpy, else PIL).
    """
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{dataset_name}_{cfg.task}.jsonl")
    info_path = os.path.join(out_dir, f"{dataset_name}_{cfg.task}_info.json")
    if os.path.exists(out_path) and not overwrite:
        return out_path  # skip-if-done resume (reference infer_cot.py:620-623)

    load_image = load_image or default_load_image
    mcfg = runner.cfg
    if build_prompt is None:
        def build_prompt(query):
            return (
                [mcfg.vision_start_token_id, mcfg.image_token_id, mcfg.vision_end_token_id]
                + tokenize(query)
            )

    reset_logger_stats()
    results: List[Dict[str, Any]] = []
    total_time = 0.0
    n_calls = 0

    with LoggerControl(time_active=True, memory_active=True):
        for start in range(0, len(samples), cfg.batch_size):
            batch = samples[start : start + cfg.batch_size]
            prompts = [build_prompt(s.query) for s in batch]
            images = [load_image(s.img_path) for s in batch]
            bboxes = [s.normed_bboxes for s in batch]
            have_boxes = any(b is not None for b in bboxes)
            prep = prepare_inputs(
                runner.cfg, prompts, images,
                normed_bboxes=bboxes if have_boxes else None,
                max_pixels=cfg.max_pixels,
            )
            t0 = time.perf_counter()
            if cfg.task == "glimpse":
                out = runner.glimpse(prep, use_ref_masks=cfg.use_ref_masks)
                keep = out.keep_img.cpu().numpy()
                responses = [None] * len(batch)
                num_gen = [0] * len(batch)
            else:
                if cfg.compressor:
                    res = runner.generate_compressed(
                        prep, cfg.compressor,
                        max_new_tokens=cfg.max_new_tokens,
                        **cfg.compressor_kwargs,
                    )
                else:
                    res = runner.generate(
                        prep,
                        max_new_tokens=cfg.max_new_tokens,
                        do_selection=cfg.do_selection,
                        use_ref_masks=cfg.use_ref_masks,
                    )
                keep = res.keep_img
                responses = _responses(res, len(batch), detokenize)
                num_gen = [int(x) for x in res.num_generated]
            total_time += time.perf_counter() - t0
            n_calls += 1

            for b, s in enumerate(batch):
                rec: Dict[str, Any] = {
                    "question_id": s.sample_id,
                    "dataset": dataset_name,
                    "query": s.query,
                    "answer": s.answer,
                    "response": responses[b],
                    "num_gen_tokens": num_gen[b],
                    # lets a viewer render the source image next to the
                    # mask overlay (reference results_vis_compare.py
                    # resolves images per-dataset)
                    "img_path": s.img_path,
                }
                if keep is not None:
                    n_tok = int(prep.n_img_tokens[b])
                    ref = (
                        prep.ref_token_masks[b]
                        if prep.ref_token_masks is not None and s.normed_bboxes
                        else None
                    )
                    rec.update(cal_box_metrics(keep[b], ref, n_tok))
                    if cfg.save_masks:
                        rec["keep_mask"] = keep[b, :n_tok].astype(int).tolist()
                        rec["token_grid"] = [
                            int(prep.grids[b][1] // mcfg.vision.spatial_merge_size),
                            int(prep.grids[b][2] // mcfg.vision.spatial_merge_size),
                        ]
                results.append(rec)

    with open(out_path, "w") as f:
        for rec in results:
            f.write(json.dumps(rec) + "\n")

    masked = [r for r in results if "iou" in r]
    info = {
        "dataset": dataset_name,
        "task": cfg.task,
        "config": asdict(cfg),
        "num_samples": len(results),
        "avg_call_time_s": total_time / max(n_calls, 1),
        "avg_gen_tokens": float(np.mean([r["num_gen_tokens"] for r in results]))
        if results
        else 0.0,
        "mean_iou": float(np.mean([r["iou"] for r in masked])) if masked else None,
        "mean_mask_ratio": float(np.mean([r["mask_ratio"] for r in results if "mask_ratio" in r]))
        if results
        else None,
        "logger_stats": get_logger_stats(),
    }
    with open(info_path, "w") as f:
        json.dump(info, f, indent=2)
    return out_path

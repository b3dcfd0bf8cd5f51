"""Two-track evaluation harness (reference L5, SURVEY.md §2.6), the
counterpart of glimpseprune_tpu/evalsuite with the same exports:

- free-form VisCoT inference (`infer.py`): generate / glimpse / compressor
  tasks over VisCoT benchmark JSONs through the port's runner, jsonl +
  info.json artifacts, mask metrics, skip-if-done resume, per-host data
  sharding
- scoring (`scorers.py` / `judge.py`): LLM-judge over an OpenAI-compatible
  HTTP endpoint plus offline scorers (precise_match, single_choice,
  one_box_iou05) with line-level resume
- short-form VQA (`shortform.py`, `protocols.py`): the official protocols
  of the reference's ten lmms-eval tasks, driven in-process
"""

from glimpseprune_torch.evalsuite.data import (
    DATASET_MAPPERS,
    EvalSample,
    load_benchmark,
    shard_for_host,
)
from glimpseprune_torch.evalsuite.infer import InferenceConfig, run_inference
from glimpseprune_torch.evalsuite.scorers import SCORERS, score_results
from glimpseprune_torch.evalsuite.judge import LLMClient

__all__ = [
    "DATASET_MAPPERS",
    "EvalSample",
    "load_benchmark",
    "shard_for_host",
    "InferenceConfig",
    "run_inference",
    "SCORERS",
    "score_results",
    "LLMClient",
]

"""Staged in-LLM dropping (PyramidDrop): the stage schedule.

Counterpart of glimpseprune_tpu/compressors/staged.py. Each stage runs a
layer range, harvests the last token's attention row, keeps the top
``ratio`` of the image tokens and compacts everything
(``Qwen2_5_VL_GP.staged_prefill``). The stage budgets are static
(ratios x N), so each stage's compacted length is known before the run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass(frozen=True)
class StagedDropConfig:
    """stages: (layer_rank, keep_ratio) pairs, strictly increasing layers,
    decreasing ratios (reference layer_list / image_token_ratio_list)."""

    stages: Tuple[Tuple[int, float], ...] = ((8, 0.5), (16, 0.25), (24, 0.125))

    def validate(self, num_layers: int):
        prev_l, prev_r = -1, 1.01
        for l, r in self.stages:
            if not (0 <= l < num_layers):
                raise ValueError(f"stage layer {l} outside [0, {num_layers})")
            if l <= prev_l or r >= prev_r:
                raise ValueError("stages must have increasing layers and decreasing ratios")
            prev_l, prev_r = l, r
        return self


def staged_drop_schedule(
    n_img_max: int, seq_len: int, stages: Sequence[Tuple[int, float]],
    round_to: int = 64,
) -> List[int]:
    """Static out_len per stage: text budget stays, image budget shrinks."""

    def round_up(x):
        return ((x + round_to - 1) // round_to) * round_to

    outs = []
    text_budget = seq_len - n_img_max
    for _, ratio in stages:
        keep = max(int(ratio * n_img_max), 1)
        outs.append(round_up(text_budget + keep))
    return outs

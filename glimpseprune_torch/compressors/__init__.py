"""Baseline visual-token compressors: VisionZip, DivPrune, CDPruner, VScan
and PyramidDrop's staged drops.

Counterpart of glimpseprune_tpu/compressors/. Every method is a
static-budget selector over batched [B, N, D] image tokens that shares the
GlimpsePrune compaction: the runner's ``generate_compressed``
(models/qwen2_5_vl/runner.py) prunes before the LLM (visionzip, divprune,
cdpruner, vscan) or inside it (pdrop, ``Qwen2_5_VL_GP.staged_prefill``).

- visionzip: attention-dominant top-k + uniform-stride contextual merge
- divprune:  greedy max-min diversity (no attention, training-free)
- cdpruner:  conditional-DPP greedy MAP (relevance x similarity kernel)
- vscan:     window-capped local + global picks, dropped tokens merged
- staged:    the stage schedule of text-guided drops inside the LLM

The greedy loops (DivPrune, CDPruner) run their k steps on the device
without reading anything back to the host.
"""

from glimpseprune_torch.registry import Registry

COMPRESSORS: Registry = Registry("compressor")

from glimpseprune_torch.compressors.visionzip import visionzip_select  # noqa: E402
from glimpseprune_torch.compressors.divprune import divprune_select  # noqa: E402
from glimpseprune_torch.compressors.cdpruner import cdpruner_select  # noqa: E402
from glimpseprune_torch.compressors.staged import (  # noqa: E402
    StagedDropConfig,
    staged_drop_schedule,
)

__all__ = [
    "COMPRESSORS",
    "visionzip_select",
    "divprune_select",
    "cdpruner_select",
    "StagedDropConfig",
    "staged_drop_schedule",
]

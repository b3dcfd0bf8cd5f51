"""Base GlimpsePrune training: losses, the train step, data, the trainer.

Counterpart of glimpseprune_tpu/training/ (the base recipe; GlimpsePrune+
LoRA and GRPO are not ported)."""

from glimpseprune_torch.training.losses import LOSSES, bce_loss, dice_loss, mask_loss
from glimpseprune_torch.training.train_step import (
    AdamW,
    compute_loss,
    init_trainable,
    make_train_step,
    new_module_filter,
    split_params,
)

__all__ = [
    "LOSSES",
    "dice_loss",
    "bce_loss",
    "mask_loss",
    "AdamW",
    "compute_loss",
    "init_trainable",
    "make_train_step",
    "new_module_filter",
    "split_params",
]

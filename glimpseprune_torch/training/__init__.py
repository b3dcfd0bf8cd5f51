"""GlimpsePrune training: losses, the train step, data, the trainer, and
GlimpsePrune+ (LoRA adapters and the GRPO trainer).

Counterpart of glimpseprune_tpu/training/ (the base recipe, ``lora.py`` and
``grpo.py``)."""

from glimpseprune_torch.training.grpo import (
    SCORE_FUNCS,
    GRPOBatch,
    GRPOTrainer,
    compute_ref_logps,
    grpo_surrogate,
    k3_kl,
    make_grpo_loss_step,
    token_logprobs,
    whiten_group_scores,
)
from glimpseprune_torch.training.lora import (
    apply_lora,
    insert_lora,
    lora_disabled,
    lora_param_count,
    make_lora_params,
)
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
    "SCORE_FUNCS",
    "GRPOBatch",
    "GRPOTrainer",
    "compute_ref_logps",
    "grpo_surrogate",
    "k3_kl",
    "make_grpo_loss_step",
    "token_logprobs",
    "whiten_group_scores",
    "apply_lora",
    "insert_lora",
    "lora_disabled",
    "lora_param_count",
    "make_lora_params",
]

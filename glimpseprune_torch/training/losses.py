"""Mask-supervision losses and mask metrics.

Counterpart of glimpseprune_tpu/training/losses.py (reference
train_qwen_gp.py:224-344): batched [B, N] mask logits with a validity mask,
fp32 math.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from glimpseprune_torch.registry import Registry

LOSSES: Registry = Registry("loss")


@LOSSES.register("dice")
def dice_loss(mask_logits: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
              smooth: float = 1e-6) -> torch.Tensor:
    """1 - (2 |p t| + smooth) / (|p| + |t| + smooth) per row, batch mean."""
    probs = torch.sigmoid(mask_logits.float())
    zero = torch.zeros((), device=probs.device)
    probs = torch.where(valid, probs, zero)
    t = torch.where(valid, target.float(), zero)
    inter = (probs * t).sum(-1)
    denom = probs.sum(-1) + t.sum(-1)
    return (1.0 - (2 * inter + smooth) / (denom + smooth)).mean()


@LOSSES.register("bce")
def bce_loss(mask_logits: torch.Tensor, target: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits: per-row mean over the row's valid
    tokens, then the batch mean (the reference averages per sample)."""
    x = mask_logits.float()
    per = F.relu(x) - x * target.float() + torch.log1p(torch.exp(-x.abs()))
    per = torch.where(valid, per, torch.zeros((), device=x.device))
    return (per.sum(-1) / valid.sum(-1).clamp(min=1)).mean()


@LOSSES.register("mask")
def mask_loss(mask_logits: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
              dice_weight: float = 1.0, bce_weight: float = 0.1) -> torch.Tensor:
    """Weighted dice + bce (reference MaskLoss, dice 1.0 and bce 0.1)."""
    return (dice_weight * dice_loss(mask_logits, target, valid)
            + bce_weight * bce_loss(mask_logits, target, valid))


def mask_confusion_stats(keep: torch.Tensor, target: torch.Tensor,
                         valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-row TP / FP / FN / TN counts and IoU of a predicted keep mask."""
    keep = keep & valid
    t = target & valid
    tp = (keep & t).sum(-1)
    fp = (keep & ~t).sum(-1)
    fn = (~keep & t).sum(-1)
    tn = (valid & ~keep & ~t).sum(-1)
    iou = tp / (tp + fp + fn).clamp(min=1)
    return {"tp": tp, "fp": fp, "fn": fn, "tn": tn, "iou": iou}

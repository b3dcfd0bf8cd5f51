"""Base GP training step: mask loss with deep supervision + answer NLL.

Counterpart of glimpseprune_tpu/training/train_step.py (reference
GPTrainer.compute_loss with reward_weight 0, train_qwen_gp.py:1531-1553):
one glimpse-encode forward yields every fuser layer's mask logits and the
answer's next-token NLL; only the GlimpsePrune modules (``NEW_MODULE_KEYS``)
are trained, in fp32, and the base model stays frozen (no gradients, its
own dtype). ``AdamW`` holds the optimizer to optax's formulas
(``optax.chain(clip_by_global_norm, adamw)``, as the JAX trainer builds it),
so the CPU parity tests hold at fp32 tolerance.

On a (data, model) mesh (parallel/mesh.py) the step takes this data rank's
rows of the batch (``shard_batch``) and the model may be sharded over the
model axis (``shard_params``), whose layers carry the gradient to the
trainable modules through their collectives. The data ranks' gradients are
then summed, each rank's losses weighted so that the sum is the whole
batch's gradient: the mask losses are means over rows (weight: this rank's
rows over all of them), the answer NLL a mean over the labelled tokens
(weight: this rank's labelled tokens over all of them), as in JAX, where
GSPMD computes the whole batch's means.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from glimpseprune_torch.parallel.mesh import shard_batch
from glimpseprune_torch.parallel.sequence import all_reduce_sum
from glimpseprune_torch.training.losses import mask_confusion_stats, mask_loss

NEW_MODULE_KEYS = ("attn_fuser", "learnable_embeddings", "le_proj", "le_norm")


def new_module_filter(name: str) -> bool:
    """Whether a parameter name (``model.named_parameters()``) is trained."""
    return name.split(".")[0] in NEW_MODULE_KEYS


def split_params(model: nn.Module) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """-> (trainable GlimpsePrune parameters, frozen rest), by name."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        (trainable if new_module_filter(name) else frozen)[name] = p
    return trainable, frozen


def init_trainable(model: nn.Module) -> Dict[str, nn.Parameter]:
    """Make the GlimpsePrune parameters fp32 and trainable and freeze the
    rest, in place -> the trainable parameters by name."""
    trainable, frozen = split_params(model)
    for p in frozen.values():
        p.requires_grad_(False)
    for p in trainable.values():
        p.data = p.data.float()
        p.requires_grad_(True)
    return trainable


class AdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(lr, b1, b2,
    eps, weight_decay=weight_decay))`` over named fp32 parameters.

    Per step t (from 1), with g the gradient after clipping (g * max_norm /
    |g| when the global norm |g| >= max_norm, else g):
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
    u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + weight_decay p,
    p = p - lr(t - 1) u. The bias corrections are taken in fp32 as optax
    takes them; ``torch.optim.AdamW`` adds eps to a differently rounded
    denominator and clips with a +1e-6, so it is not used."""

    def __init__(self, params: Dict[str, nn.Parameter],
                 learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, max_grad_norm: Optional[float] = None):
        self.params = dict(params)
        self.schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = {k: (torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                     else p.grad.float()) for k, p in self.params.items()}
        if self.max_grad_norm:
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            keep = norm < self.max_grad_norm
            grads = {k: torch.where(keep, g, g / norm * self.max_grad_norm)
                     for k, g in grads.items()}
        t = self.count + 1
        bc1 = 1.0 - float(torch.tensor(self.b1, dtype=torch.float32) ** t)
        bc2 = 1.0 - float(torch.tensor(self.b2, dtype=torch.float32) ** t)
        lr = float(self.schedule(self.count))
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = (1.0 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1.0 - self.b2) * (g * g) + self.b2 * self.nu[k]
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * -lr)
        self.count = t

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for k, p in self.params.items():
            self.mu[k] = state["mu"][k].to(device=p.device, dtype=torch.float32)
            self.nu[k] = state["nu"][k].to(device=p.device, dtype=torch.float32)


def compute_loss(cfg, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None, loc_weight: float = 1.0,
                 le_weight: float = 1.0, dice_weight: float = 1.0,
                 bce_weight: float = 0.1, row_share: float = 1.0,
                 token_share: float = 1.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The JAX ``loss_fn`` (train_step.py:59-122) -> (total, metrics).

    batch: the glimpse-encode inputs plus ref_token_masks [B, N] (the bbox
    targets) and labels [B, S], on the model's device. The ViT is frozen and
    runs without autograd. The per-layer mask losses are summed (the
    reference adds them, no layer average); total = loc_weight * loc +
    le_weight * le_loss. ``row_share`` / ``token_share``: the batch's share
    of a larger batch's rows / labelled tokens (a data rank's), which scale
    the mask terms and metrics / the answer NLL, so that the shares' sums
    are the larger batch's."""
    with torch.no_grad():
        merged, taps = model.vision_encode(batch["patches"], batch["vis_pos_ids"],
                                           batch["full_seg"], batch["vis_valid"])
    mask_logits, _, le_loss = model.glimpse_encode(
        input_ids=batch["input_ids"], valid=batch["valid"],
        position_ids=batch["position_ids"], image_embeds=merged, taps=taps,
        packed_idx=batch["packed_idx"], img_slots=batch["img_slots"],
        img_valid=batch["img_valid"], fuser_window_index=batch["fuser_window_index"],
        fuser_reverse_index=batch["fuser_reverse_index"],
        fuser_segment_ids=batch["fuser_segment_ids"], fuser_pos_ids=batch["fuser_pos_ids"],
        le_start=batch.get("le_start"), labels=batch.get("labels"), training=True,
        generator=generator)
    target, img_valid = batch["ref_token_masks"], batch["img_valid"]
    loc = torch.zeros((), dtype=torch.float32, device=mask_logits.device)
    for i in range(mask_logits.shape[0]):
        loc = loc + mask_loss(mask_logits[i], target, img_valid, dice_weight, bce_weight)
    if le_loss is None:
        le_loss = torch.zeros((), dtype=torch.float32, device=loc.device)
    loc, le_loss = loc * row_share, le_loss * token_share
    total = loc_weight * loc + le_weight * le_loss
    with torch.no_grad():
        keep = torch.sigmoid(mask_logits[-1]) > cfg.gp.reduce_threshold
        st = mask_confusion_stats(keep, target, img_valid)
        metrics = {
            "loss": total.detach(),
            "loc_loss": loc.detach(),
            "le_loss": le_loss.detach(),
            "mask_iou": st["iou"].mean() * row_share,
            "mask_precision": (st["tp"] / (st["tp"] + st["fp"]).clamp(min=1)).mean() * row_share,
            "mask_recall": (st["tp"] / (st["tp"] + st["fn"]).clamp(min=1)).mean() * row_share,
        }
    return total, metrics


def data_shares(batch: Dict[str, torch.Tensor], group) -> Tuple[float, float]:
    """(this rank's rows, its labelled tokens) over the data group's."""
    labels = batch.get("labels")
    mine = [batch["input_ids"].shape[0],
            0 if labels is None else int((labels[:, 1:] != -100).sum())]
    counts = torch.tensor(mine, dtype=torch.float64, device=batch["input_ids"].device)
    dist.all_reduce(counts, group=group)
    rows, tokens = counts.tolist()
    return mine[0] / rows, (mine[1] / tokens if tokens else 0.0)


def make_train_step(cfg, model, optimizer: AdamW, loc_weight: float = 1.0,
                    le_weight: float = 1.0, dice_weight: float = 1.0,
                    bce_weight: float = 0.1, mesh=None) -> Callable:
    """-> train_step(batch, generator) -> metrics: loss, backward through
    the trainable parameters, one optimizer update. With a ``mesh`` whose
    data axis is above 1, ``batch`` is the whole batch: each data rank
    takes its rows, and the metrics and the update are the whole batch's
    on every rank."""
    data_parallel = mesh is not None and mesh.shape["data"] > 1

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        shares = {}
        if data_parallel:
            batch = shard_batch(batch, mesh)
            shares = dict(zip(("row_share", "token_share"),
                              data_shares(batch, mesh.data.group)))
        total, metrics = compute_loss(cfg, model, batch, generator, loc_weight, le_weight,
                                      dice_weight, bce_weight, **shares)
        total.backward()
        if data_parallel:
            group = mesh.data.group
            with torch.no_grad():  # every rank reduces every parameter, in one order
                for p in optimizer.params.values():
                    p.grad = all_reduce_sum(torch.zeros_like(p) if p.grad is None else p.grad,
                                            group)
                keys = sorted(metrics)
                summed = all_reduce_sum(torch.stack([metrics[k].float() for k in keys]), group)
                metrics = dict(zip(keys, summed.unbind()))
        optimizer.step()
        return metrics

    return train_step

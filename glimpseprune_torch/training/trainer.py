"""GPTrainer: the base training loop (mask loss + answer loss).

Counterpart of glimpseprune_tpu/training/trainer.py (reference GPTrainer,
train_qwen_gp.py:1008-1623, base path): the base model is frozen, the
GlimpsePrune modules train under deep-supervised mask losses plus the
answer's cross-entropy, mask metrics are logged, and only the new modules
are checkpointed. The learning-rate schedules are optax's formulas
(``optax.warmup_cosine_decay_schedule`` and the others the JAX trainer
registers), written out in Python so the port needs no optax.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.registry import Registry
from glimpseprune_torch.training.data import GPDataset, TrainSample
from glimpseprune_torch.training.train_step import AdamW, init_trainable, make_train_step

SCHEDULERS: Registry = Registry("scheduler")


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over steps, then end."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules with one boundary: second(count - boundary)
    from the boundary on."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def _cosine(init: float, decay_steps: int, alpha: float = 0.0,
            exponent: float = 1.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * decay ** exponent + alpha)

    return schedule


def _warmup_cosine(init: float, peak: float, warmup: int, decay_steps: int,
                   end: float = 0.0, exponent: float = 1.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule."""
    alpha = 0.0 if peak == 0.0 else end / peak
    return _join(_linear(init, peak, warmup),
                 _cosine(peak, decay_steps - warmup, alpha, exponent), warmup)


@SCHEDULERS.register("constant")
def constant_schedule(lr: float, total_steps: int, warmup_steps: int = 0):
    if warmup_steps:
        return _join(_linear(0.0, lr, warmup_steps), lambda count: lr, warmup_steps)
    return lambda count: lr


@SCHEDULERS.register("linear")
def linear_schedule(lr: float, total_steps: int, warmup_steps: int = 0):
    # the JAX trainer builds this one as warmup_cosine_decay_schedule with
    # exponent 1.0, so "linear" decays along the cosine as "cosine" does
    return _warmup_cosine(0.0, lr, warmup_steps, total_steps, end=0.0, exponent=1.0)


@SCHEDULERS.register("cosine")
def cosine_schedule(lr: float, total_steps: int, warmup_steps: int = 0):
    return _warmup_cosine(0.0, lr, warmup_steps, total_steps)


@SCHEDULERS.register("exponential")
def exponential_schedule(lr: float, total_steps: int, warmup_steps: int = 0):
    """optax.exponential_decay(lr, max(total_steps, 1), 0.1)."""
    steps = max(total_steps, 1)
    return lambda count: lr if count <= 0 else lr * 0.1 ** (count / steps)


@dataclass
class TrainerConfig:
    learning_rate: float = 1e-4
    lr_scheduler: str = "cosine"
    warmup_ratio: float = 0.03
    weight_decay: float = 0.0
    num_epochs: int = 1
    batch_size: int = 2
    loc_weight: float = 1.0
    le_weight: float = 1.0
    dice_weight: float = 1.0
    bce_weight: float = 0.1
    max_grad_norm: Optional[float] = 1.0
    log_every: int = 10
    save_every: int = 500
    output_dir: str = "checkpoints/gp"
    seed: int = 0
    seq_multiple: int = 64
    patch_multiple: int = 256
    max_pixels: Optional[int] = None


def batch_from_prep(prep, device) -> Dict[str, torch.Tensor]:
    """PreparedInputs -> the batch dict the train step consumes, on device."""
    arrays = {
        "input_ids": prep.input_ids, "valid": prep.valid,
        "position_ids": prep.position_ids, "patches": prep.patches,
        "vis_pos_ids": prep.vis_pos_ids, "full_seg": prep.full_seg,
        "vis_valid": prep.vis_valid, "packed_idx": prep.packed_idx,
        "img_slots": prep.img_slots, "img_valid": prep.img_valid,
        "fuser_window_index": prep.fuser.window_index,
        "fuser_reverse_index": prep.fuser.reverse_index,
        "fuser_segment_ids": prep.fuser.segment_ids, "fuser_pos_ids": prep.fuser.pos_ids,
        "le_start": prep.le_start, "ref_token_masks": prep.ref_token_masks,
        "labels": prep.labels,
    }
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in arrays.items()}


def default_collate(cfg: ModelConfig, samples: Sequence[TrainSample], tokenize: Callable,
                    load_image: Callable, tcfg: TrainerConfig, device="cuda"):
    """Samples -> batch dict through the shared input preparation: the raw
    token variant (one image marker, then the query; the answer plus EOS as
    the labelled target), no chat template."""
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs

    prompts, answers, images, bboxes = [], [], [], []
    for s in samples:
        prompts.append([cfg.vision_start_token_id, cfg.image_token_id,
                        cfg.vision_end_token_id] + tokenize(s.query))
        answers.append(tokenize(s.answer) + [cfg.eos_token_id])
        images.append(load_image(s.img_path))
        bboxes.append(s.normed_bboxes)
    prep = prepare_inputs(cfg, prompts, images, normed_bboxes=bboxes, answer_ids=answers,
                          seq_multiple=tcfg.seq_multiple, patch_multiple=tcfg.patch_multiple,
                          max_pixels=tcfg.max_pixels)
    return batch_from_prep(prep, device)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's own random stream, a function of (seed, step) alone (the
    JAX trainer's ``fold_in(PRNGKey(seed), step)``), so a resumed run draws
    what an uninterrupted one would."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def _load_rgb(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


class GPTrainer:
    """Trains ``model``'s GlimpsePrune modules in place on ``dataset``.

    The model holds the parameters (PyTorch idiom: the JAX trainer's
    ``params`` argument has no counterpart). Its GlimpsePrune parameters
    become fp32 and trainable, the rest stays frozen in its own dtype, and
    the decoder layers always rematerialize in the backward
    (``cfg.text.remat``), as the JAX trainer forces."""

    def __init__(self, cfg: ModelConfig, model, dataset: GPDataset, tokenize: Callable,
                 load_image: Optional[Callable] = None, tcfg: Optional[TrainerConfig] = None,
                 collate: Optional[Callable] = None, resume_from: Optional[str] = None):
        if not cfg.text.remat:
            cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, remat=True))
        model.cfg, model.text.cfg = cfg, cfg.text
        self.cfg, self.model, self.dataset, self.tokenize = cfg, model, dataset, tokenize
        self.tcfg = tcfg or TrainerConfig()
        self.load_image = load_image or _load_rgb
        self.collate = collate or default_collate
        self.device = model.text.embed_tokens.weight.device

        steps_per_epoch = max(len(dataset) // self.tcfg.batch_size, 1)
        total = steps_per_epoch * self.tcfg.num_epochs
        sched = SCHEDULERS.get(self.tcfg.lr_scheduler)(
            self.tcfg.learning_rate, total, int(self.tcfg.warmup_ratio * total))
        self.optimizer = AdamW(init_trainable(model), sched,
                               weight_decay=self.tcfg.weight_decay,
                               max_grad_norm=self.tcfg.max_grad_norm)
        self.step_fn = make_train_step(cfg, model, self.optimizer,
                                       loc_weight=self.tcfg.loc_weight,
                                       le_weight=self.tcfg.le_weight,
                                       dice_weight=self.tcfg.dice_weight,
                                       bce_weight=self.tcfg.bce_weight)
        self.history: List[Dict[str, float]] = []
        self._steps_per_epoch = steps_per_epoch
        self._start_step = 0
        if resume_from:
            self.load(resume_from)

    @property
    def step(self) -> int:
        return self.optimizer.count

    def save(self, directory: Optional[str] = None) -> str:
        """The new modules, the metric history and the optimizer state."""
        from glimpseprune_torch.persistence import save_new_modules

        directory = directory or self.tcfg.output_dir
        save_new_modules(self.model, self.cfg, directory)
        with open(os.path.join(directory, "train_log.json"), "w") as f:
            json.dump(self.history, f)
        torch.save({"optimizer": self.optimizer.state_dict(), "step": self.step},
                   os.path.join(directory, "trainer_state.pt"))
        return directory

    def load(self, directory: str) -> "GPTrainer":
        """Resume from a directory written by ``save``."""
        from glimpseprune_torch.persistence import load_new_modules

        load_new_modules(self.model, directory)
        state_path = os.path.join(directory, "trainer_state.pt")
        if os.path.exists(state_path):
            state = torch.load(state_path, map_location="cpu", weights_only=True)
            self.optimizer.load_state_dict(state["optimizer"])
        log_path = os.path.join(directory, "train_log.json")
        if os.path.exists(log_path):
            with open(log_path) as f:
                self.history = json.load(f)
        self._start_step = self.step
        return self

    def train(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        step = self._start_step
        start_epoch = step // self._steps_per_epoch
        skip = step - start_epoch * self._steps_per_epoch
        t0 = time.perf_counter()
        for epoch in range(start_epoch, self.tcfg.num_epochs):
            for bi, samples in enumerate(self.dataset.batches(
                    self.tcfg.batch_size, shuffle=True, seed=self.tcfg.seed + epoch)):
                if epoch == start_epoch and bi < skip:
                    continue  # resume mid-epoch without re-running batches
                batch = self.collate(self.cfg, samples, self.tokenize, self.load_image,
                                     self.tcfg, device=self.device)
                metrics = self.step_fn(batch, step_generator(self.tcfg.seed, step, self.device))
                step += 1
                if step % self.tcfg.log_every == 0 or step == 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=step, epoch=epoch, elapsed_s=time.perf_counter() - t0)
                    self.history.append(m)
                if self.tcfg.save_every and step % self.tcfg.save_every == 0:
                    self.save()
                if max_steps and step >= max_steps:
                    self.save()
                    return self.history
        self.save()
        return self.history

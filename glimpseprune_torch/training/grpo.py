"""GlimpsePrune+ (GRPO-style RL): the score functions, the losses and the
trainer.

Counterpart of glimpseprune_tpu/training/grpo.py (reference
train_qwen_gp.py ``_generate_and_score_completions`` :1122-1396 and the
loss assembly :1402-1446, :1531-1553):

  1. the delayed-selection forward's mask logits (mixed with the bbox masks
     at ``gen_mask_usage_ratio`` < 1);
  2. the pruned prefill and G sampled completions per prompt, through the
     policy (the adapters on);
  3. the completions scored by a ``SCORE_FUNCS`` entry on the host;
  4. whitened advantages over the batch;
  5. the GRPO surrogate -exp(logp - sg(logp)) * A over completion tokens;
  6. the k3 KL to the reference policy (the same model under
     ``lora_disabled``).

One model holds the base weights once: the policy is the model with its
adapters on, the reference the same model with them off. Only the adapters
train (``make_grpo_loss_step``, the port's ``AdamW`` at optax ``adamw``'s
defaults), updated in place, so the policy runner's captured decode step
stays valid from step to step. Sampling draws from a torch.Generator, so
completions differ from the JAX package's; the mask mixing draws from the
same host ``np.random.default_rng(seed)``.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from glimpseprune_torch.models.layers import lora_disabled
from glimpseprune_torch.registry import Registry
from glimpseprune_torch.training.lora import insert_lora, lora_parameters, make_lora_params
from glimpseprune_torch.training.train_step import AdamW

SCORE_FUNCS: Registry = Registry("score_func")

# ---- train-time rewards (reference train_qwen_gp.py:715-802) ------------

# the evaluation scorers these rewards share (copies of JAX
# evalsuite/scorers.py:30-101, which the port does not import)
_CHOICE_PATTERNS = [
    r"(?:(?:the|my|the correct)\s+)?(?:answer|choice|option)\s*(?:is)?\s*[:：]?\s*([A-Z])",
    r"\(([A-Z])\)",
    r"\b([A-Z])[\.\)]",
    r"^([A-Z])\b",
    r"\b([A-Z])\b",
]
_BOX = re.compile(r"\[(\d+),\s*(\d+),\s*(\d+),\s*(\d+)\]")


def _single_choice(gt_resp, pred_resp) -> List[float]:
    scores = []
    for g, p in zip(gt_resp, pred_resp):
        g = (g or "").strip().upper()
        extracted = None
        for pat in _CHOICE_PATTERNS:
            m = re.search(pat, p or "", re.IGNORECASE)
            if m:
                extracted = m.group(1).upper()
                break
        scores.append(1.0 if extracted and extracted == g else 0.0)
    return scores


def _extract_one_bbox(text: str) -> List[float]:
    """The first [x1, y1, x2, y2] integer list in the text; zeros if none."""
    m = _BOX.search(text or "")
    return [float(x) for x in m.groups()] if m else [0, 0, 0, 0]


def _paired_box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Clamped intersection over unclamped areas, union + 1e-6."""
    x1 = np.maximum(a[:, 0], b[:, 0])
    y1 = np.maximum(a[:, 1], b[:, 1])
    x2 = np.minimum(a[:, 2], b[:, 2])
    y2 = np.minimum(a[:, 3], b[:, 3])
    inter = np.maximum(0, x2 - x1) * np.maximum(0, y2 - y1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a + area_b - inter + 1e-6)


def _gt_box(g) -> List[float]:
    """A ground-truth box as given (a list, or its string), zeros when
    malformed: it never goes through the prediction's extractor."""
    if isinstance(g, str):
        try:
            g = ast.literal_eval(g)
        except (ValueError, SyntaxError):
            return [0.0, 0.0, 0.0, 0.0]
    if isinstance(g, (list, tuple)) and len(g) == 4:
        return [float(x) for x in g]
    return [0.0, 0.0, 0.0, 0.0]


@SCORE_FUNCS.register("precision_match")
def precision_match_score(queries, answers, completions, **kw) -> List[float]:
    return [1.0 if (a or "").strip() == (c or "").strip() else 0.0
            for a, c in zip(answers, completions)]


@SCORE_FUNCS.register("single_choice")
def single_choice_score(queries, answers, completions, **kw) -> List[float]:
    return _single_choice(answers, completions)


@SCORE_FUNCS.register("one_box_iou")
def one_box_iou_score(queries, answers, completions, **kw) -> List[float]:
    pred = np.array([_extract_one_bbox(c) for c in completions])
    gt = np.array([_gt_box(a) for a in answers], dtype=np.float64)
    return _paired_box_iou(pred, gt).tolist()


@SCORE_FUNCS.register("one_box_format")
def one_box_format_score(queries, answers, completions, **kw) -> List[float]:
    """1.0 iff exactly one [x1, y1, x2, y2] integer box appears."""
    return [1.0 if len(_BOX.findall(c or "")) == 1 else 0.0 for c in completions]


@SCORE_FUNCS.register("llm")
def llm_score(queries, answers, completions, client=None, **kw) -> List[float]:
    """A judge's scores (``client.score``: a served LLM, over the network)."""
    if client is None:
        raise ValueError("the llm score function needs client= (a judge with .score)")
    return client.score(queries, completions, answers)


@SCORE_FUNCS.register("precision_match_or_llm")
def precision_match_or_llm(queries, answers, completions, client=None, **kw):
    """Exact matches score 1; the rest go to the judge, when there is one."""
    base = precision_match_score(queries, answers, completions)
    if client is None:
        return base
    todo = [i for i, s in enumerate(base) if s < 1.0]
    if todo:
        judged = client.score([queries[i] for i in todo], [completions[i] for i in todo],
                              [answers[i] for i in todo])
        for i, s in zip(todo, judged):
            base[i] = s
    return base


@SCORE_FUNCS.register("dummy")
def dummy_score(queries, answers, completions, **kw) -> List[float]:
    return [float(len(c or "") % 3) / 2.0 for c in completions]


# ---- the losses ----------------------------------------------------------


def whiten_group_scores(scores: torch.Tensor, num_generations: int) -> torch.Tensor:
    """Scores [B*G] -> advantages: minus the mean of all scores, over their
    unbiased std (ddof=1) + 1e-4, as the reference does (global, not per
    group of G; train_qwen_gp.py:1375-1378)."""
    del num_generations  # the reference whitens over the whole batch
    return (scores - scores.mean()) / (scores.std(unbiased=True) + 1e-4)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """[B, T, V] logits and [B, T] token ids -> [B, T] log p(token)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, tokens.long()[..., None])[..., 0]


def _seq_mean(per_tok: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The token mean of each sequence, then the batch mean."""
    return (per_tok.sum(-1) / mask.sum(-1).clamp(min=1)).mean()


def grpo_surrogate(policy_logps: torch.Tensor, advantages: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """-exp(logp - sg(logp)) * A over the completion tokens (mask [B, T]),
    so long completions weigh no more than short ones (reference
    train_qwen_gp.py:1424-1446)."""
    ratio = torch.exp(policy_logps - policy_logps.detach())
    return _seq_mean(-ratio * advantages[:, None] * mask, mask)


def k3_kl(policy_logps: torch.Tensor, ref_logps: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """The k3 KL estimate exp(ref - pol) - (ref - pol) - 1 (reference
    :1402-1421), weighted as ``grpo_surrogate``."""
    diff = ref_logps - policy_logps
    return _seq_mean((torch.exp(diff) - diff - 1.0) * mask, mask)


class GRPOBatch(NamedTuple):
    """One GRPO loss step's tensors, on the model's device. The prompt side
    is the pruned geometry of ``GlimpseOutputs`` (one row per sample of a
    group); the completions are the sampled ids with their eos-aware
    mask."""

    prompt_embeds: torch.Tensor     # [B*G, R, H] kept layer-0 embeddings
    prompt_valid: torch.Tensor      # [B*G, R]
    prompt_pos: torch.Tensor        # [3, B*G, R]
    completion_ids: torch.Tensor    # [B*G, Tc]
    completion_valid: torch.Tensor  # [B*G, Tc]
    completion_pos: torch.Tensor    # [3, B*G, Tc]
    advantages: torch.Tensor        # [B*G]
    ref_logps: torch.Tensor         # [B*G, Tc] the reference policy's logprobs


def completion_logps(model, batch: GRPOBatch) -> torch.Tensor:
    """log p of each completion token under model as it stands [B*G, Tc]."""
    return model.completion_logprobs(batch.prompt_embeds, batch.prompt_valid, batch.prompt_pos,
                                     batch.completion_ids, batch.completion_valid,
                                     batch.completion_pos)


@torch.no_grad()
def compute_ref_logps(model, batch: GRPOBatch) -> torch.Tensor:
    """The reference policy's logprobs: model with its adapters disabled."""
    with lora_disabled(model):
        return completion_logps(model, batch)


def make_grpo_loss_step(model, optimizer: AdamW, reward_weight: float = 1.0,
                        kd_weight: float = 0.04) -> Callable[[GRPOBatch], Dict[str, torch.Tensor]]:
    """-> grpo_step(batch) -> metrics: the policy's (model's, adapters on)
    completion logprobs, reward_weight * surrogate + kd_weight * k3 KL,
    its backward into the adapters (``optimizer``'s parameters) and one
    optimizer update in place."""

    def step(batch: GRPOBatch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        logps = completion_logps(model, batch)
        cmask = batch.completion_valid.float()
        reward_loss = grpo_surrogate(logps, batch.advantages, cmask)
        kd_loss = k3_kl(logps, batch.ref_logps, cmask)
        total = reward_weight * reward_loss + kd_weight * kd_loss
        total.backward()
        optimizer.step()
        return {"reward_loss": reward_loss.detach(), "kd_loss": kd_loss.detach(),
                "grpo_total": total.detach(), "mean_advantage": batch.advantages.mean()}

    return step


class GRPOTrainer:
    """GlimpsePrune+ orchestration: prune, sample G completions, score,
    step (JAX grpo.py:223-389).

    ``runner`` holds the base model. The trainer puts adapters into that
    model (``make_lora_params`` from ``seed``), binds it to the
    policy's config (``text.lora_rank``, and ``text.remat`` for the
    backward) and samples masks and completions on-policy through
    ``policy_runner``, a runner of the same model with the adapters on. The
    reference logprobs are the same model's under ``lora_disabled``; the
    base runner is bound to the old config and refuses the model from then
    on."""

    def __init__(self, cfg, runner, dataset, tokenize: Callable, detokenize: Callable,
                 num_generations: int = 4, max_new_tokens: int = 32,
                 temperature: float = 1.0, score_fn: str = "dummy", score_client=None,
                 reward_weight: float = 1.0, kd_weight: float = 0.04, lora_rank: int = 8,
                 learning_rate: float = 1e-5, seed: int = 0,
                 gen_mask_usage_ratio: float = 1.0):
        from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

        self.cfg = cfg
        self.model = runner.model
        self.dataset = dataset
        self.tokenize = tokenize
        self.detokenize = detokenize
        self.G = num_generations
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.score_fn = SCORE_FUNCS.get(score_fn)
        self.score_client = score_client
        self.gen_mask_usage_ratio = gen_mask_usage_ratio
        scfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, lora_rank=lora_rank))
        pcfg = dataclasses.replace(scfg, text=dataclasses.replace(scfg.text, remat=True))
        insert_lora(self.model, make_lora_params(self.model, rank=lora_rank, seed=seed),
                    cfg=pcfg)
        self.lora = lora_parameters(self.model)
        self.optimizer = AdamW(self.lora, learning_rate)  # optax.adamw's defaults
        self.step_fn = make_grpo_loss_step(self.model, self.optimizer, reward_weight, kd_weight)
        self.policy_runner = GlimpsePruneRunner(scfg, self.model)
        self.seed = seed
        # one host stream for the whole run: the mask mixing draws afresh
        # at every step (reference train_qwen_gp.py:1091-1119)
        self._host_rng = np.random.default_rng(seed)

    def mix_masks(self, prep) -> bool:
        """Replace the bbox masks of the rows drawn for generated-mask use
        (probability ``gen_mask_usage_ratio``) by the policy's predicted
        keep sets, in prep, in place; -> whether to prune with them."""
        if prep.ref_token_masks is None:
            return False
        ml, _ = self.policy_runner.glimpse_delayed(prep)
        gen_keep = (torch.sigmoid(ml[-1].float()) > self.cfg.gp.reduce_threshold).cpu().numpy()
        use_gen = self._host_rng.random(prep.input_ids.shape[0]) < self.gen_mask_usage_ratio
        mixed = prep.ref_token_masks.copy()
        mixed[use_gen] = gen_keep[use_gen]
        prep.ref_token_masks = mixed
        return True

    def step_on_batch(self, samples: Sequence, load_image: Callable,
                      rng: Optional[torch.Generator] = None) -> Dict[str, float]:
        """One GRPO step on samples (each repeated G times); completions
        are sampled from rng (a torch.Generator on the model's device)."""
        from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs

        cfg, g = self.cfg, self.G
        prompts, images, queries, answers, bboxes = [], [], [], [], []
        for s in samples:
            p = [cfg.vision_start_token_id, cfg.image_token_id,
                 cfg.vision_end_token_id] + self.tokenize(s.query)
            for _ in range(g):  # RepeatRandomSampler's order
                prompts.append(p)
                images.append(load_image(s.img_path))
                queries.append(s.query)
                answers.append(s.answer)
                bboxes.append(getattr(s, "normed_bboxes", None))
        if self.gen_mask_usage_ratio >= 1.0 or not any(bboxes):
            bboxes = None
        prep = prepare_inputs(cfg, prompts, images, normed_bboxes=bboxes, seq_multiple=8,
                              patch_multiple=16)
        use_ref = bboxes is not None and self.mix_masks(prep)
        out = self.policy_runner.glimpse(prep, use_ref_masks=use_ref)
        seqs, n_gen = self.policy_runner._decode_loop(
            out.logits, out.valid, out.position_ids, out.kv_k, out.kv_v, self.max_new_tokens,
            cfg.eos_token_id, temperature=self.temperature, rng=rng)
        completions = [self.detokenize([int(x) for x in seqs[i, :n_gen[i]]])
                       for i in range(len(prompts))]
        scores = np.asarray(self.score_fn(queries, answers, completions,
                                          client=self.score_client), dtype=np.float32)
        dev = out.valid.device
        tc = seqs.shape[1]
        # the prefill's tensors are inference tensors: clone them for autograd
        last = out.position_ids[:, :, -1].clone()  # [3, B*G]
        batch = GRPOBatch(
            prompt_embeds=out.embeds.clone(), prompt_valid=out.valid.clone(),
            prompt_pos=out.position_ids.clone(),
            completion_ids=torch.as_tensor(seqs, device=dev),
            completion_valid=torch.arange(tc, device=dev)[None, :]
            < torch.as_tensor(n_gen, device=dev)[:, None],
            completion_pos=last[:, :, None] + 1 + torch.arange(tc, device=dev),
            advantages=whiten_group_scores(torch.as_tensor(scores, device=dev), g),
            ref_logps=torch.zeros(seqs.shape, device=dev))
        batch = batch._replace(ref_logps=compute_ref_logps(self.model, batch))
        metrics = {k: float(v) for k, v in self.step_fn(batch).items()}
        metrics["mean_score"] = float(scores.mean())
        return metrics

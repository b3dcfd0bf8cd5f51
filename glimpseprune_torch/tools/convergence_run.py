"""Multi-hundred-step convergence run on a synthetic boxes dataset;
counterpart of tools/convergence_run.py.

Stand-in for the reference's <1 h / 20K-GQA base recipe (README.md:24,49):
images hold a bright rectangle on noise; the box is the supervision
target. The GlimpsePrune modules (fuser and glimpse embeddings) must learn
to keep exactly the box's tokens: loss falls and mask IoU climbs if the
recipe converges. Writes the trainer's checkpoint (new modules,
``train_log.json``) and ``convergence_summary.json`` under ``--out``;
``--resume-from`` continues a killed run (reference
--resume_from_checkpoint). ``--grpo`` runs the GlimpsePrune+ stage at
``--scale tiny``: GRPO on LoRA adapters with an offline scorer,
interleaved with base steps, logged to ``grpo_log.json``.

The frozen base has random weights drawn from ``--seed`` (no checkpoint is
needed): ``--scale`` picks the bench's config (``tools.common.
bench_config``: 1b, 3b, 7b, or the tiny test config), ``--quant`` its
weight-only tier, drawn straight into int8 / int4 on the device. The
frozen base is bf16 on a card (the kernels' dtype) and fp32 on the CPU;
the trained modules are fp32.

  python -m glimpseprune_torch.tools.convergence_run --scale 7b --quant int8 --steps 300 \\
      --out ckpt/conv
  python -m glimpseprune_torch.tools.convergence_run --scale 7b --quant int8 --steps 300 \\
      --out ckpt/conv --resume-from ckpt/conv      # continue after a kill
  python -m glimpseprune_torch.tools.convergence_run --grpo --scale tiny --steps 30 --out g
  python -m glimpseprune_torch.tools.convergence_run --scale tiny --img-side 112 \\
      --steps 20 --out conv --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def _corpus_config(root: str, name: str, rows: List[dict]):
    jsonl = os.path.join(root, f"{name}_train.jsonl")
    with open(jsonl, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return {
        "datasets": [{
            "json_path": jsonl,
            "mapper": "cot_train",
            "bbox_type": "xyxy",
            "additional_mappers": ["norm_bboxes"],
        }]
    }, os.path.join(root, "imgs")


def make_synth_corpus(root: str, n: int, img_side: int, seed: int = 0):
    """Images: noise + one bright rectangle (JPEG, quality 92); label bbox
    = the rectangle -> (dataset config, image root)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "imgs", "cot", "synth")
    os.makedirs(img_dir, exist_ok=True)
    rows = []
    for i in range(n):
        arr = rng.integers(0, 90, (img_side, img_side, 3), dtype=np.uint8)
        w = int(rng.integers(img_side // 6, img_side // 2))
        h = int(rng.integers(img_side // 6, img_side // 2))
        x0 = int(rng.integers(0, img_side - w))
        y0 = int(rng.integers(0, img_side - h))
        color = rng.integers(170, 255, (3,), dtype=np.uint8)
        arr[y0: y0 + h, x0: x0 + w] = color
        name = f"img{i}.jpg"
        Image.fromarray(arr).save(os.path.join(img_dir, name), quality=92)
        rows.append({
            "question": "Where is the bright rectangle?",
            "answer": f"at ({x0},{y0})",
            "image": name,
            "width": img_side,
            "height": img_side,
            "bboxs": [[float(x0), float(y0), float(x0 + w), float(y0 + h)]],
            "dataset": "synth",
            "split": "train",
        })
    return _corpus_config(root, "synth", rows)


def make_grpo_corpus(root: str, n: int, img_side: int, answers: str = "lr", seed: int = 0):
    """GRPO task: bright rectangle on noise; the answer is one char, 'l' /
    'r' for the half the box's centre sits in (``answers="lr"``, the visual
    task) or a constant 'x' (``answers="const"``, the pure-RL sanity task).
    One-char answers and the bijective ``char_tokenizer`` make
    ``precision_match`` a real 0/1 reward that a random policy can find by
    sampling: the offline-scorer analogue of the reference's RL stage,
    which trains against an LLM judge (train_qwen_gp.py:1122-1446)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "imgs", "cot", "synthrl")
    os.makedirs(img_dir, exist_ok=True)
    rows = []
    for i in range(n):
        arr = rng.integers(0, 90, (img_side, img_side, 3), dtype=np.uint8)
        w = int(rng.integers(img_side // 4, img_side // 2))
        h = int(rng.integers(img_side // 4, img_side // 2))
        # keep the box centre unambiguously in one half
        left = bool(rng.integers(0, 2))
        x0 = int(rng.integers(0, img_side // 2 - w)) if left else \
            int(rng.integers(img_side // 2, img_side - w))
        y0 = int(rng.integers(0, img_side - h))
        arr[y0: y0 + h, x0: x0 + w] = rng.integers(170, 255, (3,), dtype=np.uint8)
        name = f"rl{i}.jpg"
        Image.fromarray(arr).save(os.path.join(img_dir, name), quality=92)
        rows.append({
            "question": "which half?",
            "answer": ("l" if left else "r") if answers == "lr" else "x",
            "image": name,
            "width": img_side,
            "height": img_side,
            "bboxs": [[float(x0), float(y0), float(x0 + w), float(y0 + h)]],
            "dataset": "synthrl",
            "split": "train",
        })
    return _corpus_config(root, "synthrl", rows)


def char_tokenizer():
    """Bijective char <-> id map (ids 5..132, inside every vocabulary the
    configs have): detokenized completions are real strings, so the
    offline score functions judge them as the reference's registry does
    (train_qwen_gp.py:715-802). ``detok``'s guard is the JAX tool's
    (``5 <= i < 133``)."""
    def tok(t):
        return [5 + ord(c) for c in t[:48] if ord(c) < 128]

    def detok(ids):
        return "".join(chr(i - 5) if 5 <= i - 5 + 5 < 133 else "?" for i in ids)

    return tok, detok


def tiny_tokenize(text: str) -> List[int]:
    """The JAX tiny demo model's tokenizer (tools/demo.py ``TinyTok``)."""
    return [5 + ord(c) % 400 for c in text[:32]]


def wide_tokenize(text: str) -> List[int]:
    """The JAX tool's tokenizer at the 1b / 3b / 7b scales."""
    return [5 + (ord(c) % 2000) for c in text]


@dataclass
class ConvergenceRun:
    """What a stage returns: its metric history, a summary (timing, peak,
    the frozen base's checksums), and the trained model with its config."""

    history: List[Dict[str, Any]]
    summary: Dict[str, Any] = field(default_factory=dict)
    cfg: Any = None
    model: Any = None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="3b", choices=["tiny", "1b", "3b", "7b"])
    ap.add_argument("--quant", default="", choices=["", "int8", "int4"],
                    help="weight-only tier of the frozen base")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--n-samples", type=int, default=256)
    ap.add_argument("--img-side", type=int, default=560)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--out", default="checkpoints/convergence")
    ap.add_argument("--data-root", default=None, help="corpus directory (default OUT/data)")
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10,
                    help="steps between history rows (and step 1)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--grpo", action="store_true", help="GlimpsePrune+ (GRPO) stage")
    ap.add_argument("--grpo-g", type=int, default=8)
    ap.add_argument("--grpo-new-tokens", type=int, default=1)
    ap.add_argument("--grpo-score", default="precision_match")
    ap.add_argument("--grpo-answers", default="lr", choices=["lr", "const"])
    ap.add_argument("--grpo-rank", type=int, default=4)
    ap.add_argument("--grpo-lr", type=float, default=3e-3)
    ap.add_argument("--grpo-base-every", type=int, default=1,
                    help="base loc/le step every N GRPO steps (0 = off)")
    ap.add_argument("--grpo-probe-every", type=int, default=25)
    return ap


def base_model(args):
    """(config, model) of the frozen base from the arguments: the bench's
    config at ``--scale``, in ``--quant``'s weight-only tier, random weights
    from ``--seed`` on ``--device`` (quantized kernels drawn straight into
    int8 / int4). Raises if a drawn quantized tensor is all zeros: a base
    quantized from placeholder zeros trains to a pinned uniform CE."""
    import torch

    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.layers import QuantLinear
    from glimpseprune_torch.tools.common import bench_config, resolve_device, tier_config
    from glimpseprune_torch.utils.fastinit import device_random_params

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    cfg = tier_config(bench_config(args.scale), args.quant, kv_quant="", weights_only=True)
    model = (device_random_params(cfg, args.seed, dev, dtype) if args.quant
             else init_random(cfg, args.seed, dev, dtype))
    zero = [n for n, m in model.named_modules() if isinstance(m, QuantLinear)
            and not bool((m.kernel_q if m.mode == "int8" else m.kernel_q4).any())]
    if zero:
        raise AssertionError(f"quantized weights drawn all zero: {zero[:4]}")
    return cfg, model.set_config(cfg)


def scale_inputs(scale: str):
    """((seq_multiple, patch_multiple), tokenizer) of the base stage at a
    scale, as the JAX tool sets them."""
    return ((8, 16), tiny_tokenize) if scale == "tiny" else ((64, 256), wide_tokenize)


def run_base(args, cfg=None, model=None) -> ConvergenceRun:
    """The base stage: GPTrainer over the synthetic boxes corpus. ``cfg`` /
    ``model`` (both or neither) replace the random base of ``base_model``."""
    from glimpseprune_torch.tools.common import (
        base_checksum,
        peak_gib,
        reset_peak,
        resolve_device,
        sync,
    )
    from glimpseprune_torch.training.data import GPDataset
    from glimpseprune_torch.training.trainer import GPTrainer, TrainerConfig, default_collate

    dev = resolve_device(args.device)
    (seq_mult, patch_mult), tokenize = scale_inputs(args.scale)
    data_root = args.data_root or os.path.join(args.out, "data")
    os.makedirs(data_root, exist_ok=True)
    config, img_dir = make_synth_corpus(data_root, args.n_samples, args.img_side)
    if model is None:
        cfg, model = base_model(args)
    dataset = GPDataset(config, img_dir=img_dir, tokenize=tokenize)
    print(f"dataset: {len(dataset)} synthetic samples, device={dev}")
    checksum_before = base_checksum(model)

    tcfg = TrainerConfig(
        learning_rate=args.lr, batch_size=args.batch_size,
        num_epochs=max(1, args.steps * args.batch_size // max(len(dataset), 1) + 1),
        log_every=args.log_every, save_every=args.save_every, output_dir=args.out,
        seq_multiple=seq_mult, patch_multiple=patch_mult,
    )
    host_s = [0.0]

    def collate(*a, **kw):  # prepare_inputs and the copy to the device, timed
        t0 = time.perf_counter()
        out = default_collate(*a, **kw)
        host_s[0] += time.perf_counter() - t0
        return out

    trainer = GPTrainer(cfg, model, dataset, tokenize, tcfg=tcfg, collate=collate,
                        resume_from=args.resume_from)
    reset_peak(dev)
    t0 = time.perf_counter()
    history = trainer.train(max_steps=args.steps)
    sync(dev)
    wall = time.perf_counter() - t0

    print("\nstep   loss     loc     le      IoU    prec   recall")
    for h in history:
        if h["step"] % 50 == 0 or h["step"] == 1 or h is history[-1]:
            print(f"{h['step']:5d} {h['loss']:7.3f} {h['loc_loss']:7.3f} "
                  f"{h['le_loss']:7.3f} {h['mask_iou']:6.3f} "
                  f"{h['mask_precision']:6.3f} {h['mask_recall']:6.3f}")
    first, last = history[0], history[-1]
    ran = max(last["step"] - trainer._start_step, 1)
    print(f"\nloss {first['loss']:.3f} -> {last['loss']:.3f}; "
          f"IoU {first['mask_iou']:.3f} -> {last['mask_iou']:.3f} "
          f"in {last['step']} steps "
          f"({(last['elapsed_s'] / ran):.2f}s/step)")
    summary = {
        "scale": args.scale, "quant": args.quant, "start_step": trainer._start_step,
        "last_step": last["step"], "steps_run": last["step"] - trainer._start_step,
        "wall_s": wall, "s_per_step": wall / ran, "host_s": host_s[0],
        "host_share": host_s[0] / wall if wall else None, "peak_gib": peak_gib(dev),
        "base_checksum_before": checksum_before, "base_checksum_after": base_checksum(model),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "convergence_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("summary: " + json.dumps(summary))
    return ConvergenceRun(history, summary, trainer.cfg, model)


def probe_tokens(runner, prep, max_new_tokens: int, use_adapter: bool):
    """Greedy tokens of the pruned prefill and decode through the policy
    runner, with its model's adapters or under ``lora_disabled`` ->
    (seqs [B, max_new_tokens], num_generated [B])."""
    from glimpseprune_torch.models.layers import lora_disabled

    with contextlib.nullcontext() if use_adapter else lora_disabled(runner.model):
        out = runner.glimpse(prep)
        return runner._decode_loop(out.logits, out.valid, out.position_ids, out.kv_k,
                                   out.kv_v, max_new_tokens, runner.cfg.eos_token_id)


def run_grpo(args, cfg=None, model=None) -> ConvergenceRun:
    """GlimpsePrune+ convergence: interleaves the base loc/le recipe (the
    new modules keep training, as in the reference's joint plus loss,
    train_qwen_gp.py:1531-1553) with on-policy GRPO steps on the LoRA
    adapters, scored by an offline score function. Logs the mean reward,
    the reward / kd losses, the loc / le losses and a periodic greedy probe
    (policy against adapter-free accuracy on held-out samples) to
    ``grpo_log.json``, every 10 steps and at the end.

    One model holds the base: ``GPTrainer`` binds it to its config (remat
    on) first, then ``GRPOTrainer`` puts the adapters into it and binds it
    to the policy's config. The base step runs under ``lora_disabled``
    (the JAX tool steps ``trainer.params``, which have no adapters), and
    both probe arms go through the policy runner, the adapter-free one
    under ``lora_disabled`` (the base runner refuses an adapted model).
    Sampling draws from a torch.Generator seeded per step,
    ``trainer.step_generator(1, 2 step + 1)`` (the base step's dropout from
    ``(1, 2 step)``), in place of JAX's ``fold_in(PRNGKey(1), ...)``."""
    from glimpseprune_torch.evalsuite.data import load_image
    from glimpseprune_torch.models.layers import lora_disabled
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.tools.common import base_checksum, resolve_device
    from glimpseprune_torch.training.data import GPDataset
    from glimpseprune_torch.training.grpo import GRPOTrainer
    from glimpseprune_torch.training.trainer import GPTrainer, TrainerConfig, step_generator

    if args.scale != "tiny":
        raise SystemExit(
            "--grpo convergence runs at --scale tiny (the RL machinery is "
            "scale-independent; tools.profile_grpo_step times the 7B step)")
    dev = resolve_device(args.device)
    data_root = args.data_root or os.path.join(args.out, "data")
    os.makedirs(data_root, exist_ok=True)
    config, img_dir = make_grpo_corpus(data_root, args.n_samples, 96,
                                       answers=args.grpo_answers)
    tok, detok = char_tokenizer()
    if model is None:
        cfg, model = base_model(args)
    seq_mult, patch_mult = 8, 16
    dataset = GPDataset(config, img_dir=img_dir, tokenize=tok)
    print(f"grpo dataset: {len(dataset)} samples, device={dev}")
    checksum_before = base_checksum(model)

    tcfg = TrainerConfig(
        learning_rate=args.lr, batch_size=args.batch_size, num_epochs=1,
        log_every=10, save_every=0, output_dir=args.out,
        seq_multiple=seq_mult, patch_multiple=patch_mult,
    )
    trainer = GPTrainer(cfg, model, dataset, tok, load_image=load_image, tcfg=tcfg)
    grpo = GRPOTrainer(
        cfg, GlimpsePruneRunner(cfg, model), dataset, tok, detok,
        num_generations=args.grpo_g, max_new_tokens=args.grpo_new_tokens,
        temperature=1.0, score_fn=args.grpo_score, lora_rank=args.grpo_rank,
        learning_rate=args.grpo_lr, seed=0,
    )

    # held-out probe set: greedy accuracy policy-vs-frozen is the cleanest
    # "the adapter changed the completions" evidence
    eval_samples = [dataset[i] for i in range(min(16, len(dataset)))]
    probe_prep = prepare_inputs(
        cfg, [[cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id]
              + tok(s.query) for s in eval_samples],
        [load_image(s.img_path) for s in eval_samples],
        seq_multiple=seq_mult, patch_multiple=patch_mult)

    def probe(use_adapter: bool):
        seqs, n_gen = probe_tokens(grpo.policy_runner, probe_prep, args.grpo_new_tokens,
                                   use_adapter)
        comps = [detok([int(x) for x in seqs[i, : n_gen[i]]])
                 for i in range(len(eval_samples))]
        acc = float(np.mean([c.strip() == s.answer.strip()
                             for c, s in zip(comps, eval_samples)]))
        return acc, comps

    def dump(history):
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "grpo_log.json"), "w") as f:
            json.dump(history, f, indent=1)

    history = []
    order = np.random.default_rng(0)
    idx = []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        if len(idx) < args.batch_size:
            idx = list(order.permutation(len(dataset)))
        samples = [dataset[idx.pop()] for _ in range(args.batch_size)]

        m = {}
        if args.grpo_base_every and step % args.grpo_base_every == 0:
            batch = trainer.collate(trainer.cfg, samples, tok, load_image, tcfg, device=dev)
            with lora_disabled(model):
                bm = trainer.step_fn(batch, step_generator(1, 2 * step, dev))
            m.update({k: float(v) for k, v in bm.items()
                      if k in ("loss", "loc_loss", "le_loss", "mask_iou")})

        gm = grpo.step_on_batch(samples, load_image, step_generator(1, 2 * step + 1, dev))
        m.update(gm)
        m["step"] = step
        m["elapsed_s"] = time.time() - t0
        if step % args.grpo_probe_every == 0 or step == 1:
            acc_pol, comps = probe(use_adapter=True)
            acc_ref, _ = probe(use_adapter=False)
            m["probe_acc_policy"] = acc_pol
            m["probe_acc_frozen"] = acc_ref
            m["probe_completions"] = comps[:4]
            print(f"step {step:4d} reward {m['mean_score']:.3f} "
                  f"probe acc policy {acc_pol:.3f} vs frozen {acc_ref:.3f} "
                  f"loc {m.get('loc_loss', float('nan')):.3f} "
                  f"le {m.get('le_loss', float('nan')):.3f}", flush=True)
        history.append(m)
        if step % 10 == 0 or step == 1:
            dump(history)  # a killed run still leaves its curves

    dump(history)
    k = max(len(history) // 10, 1)
    first = float(np.mean([h["mean_score"] for h in history[:k]]))
    last = float(np.mean([h["mean_score"] for h in history[-k:]]))
    print(f"\nmean sampled reward (first-10% vs last-10% of steps): "
          f"{first:.3f} -> {last:.3f}")
    print(f"probe acc: policy {history[-1].get('probe_acc_policy')}"
          f" vs frozen {history[-1].get('probe_acc_frozen')}")
    print(f"({(history[-1]['elapsed_s'] / len(history)):.2f}s/step)")
    summary = {"first_reward": first, "last_reward": last,
               "s_per_step": history[-1]["elapsed_s"] / len(history),
               "base_checksum_before": checksum_before,
               "base_checksum_after": base_checksum(model)}
    return ConvergenceRun(history, summary, grpo.policy_runner.cfg, model)


def main(argv: Optional[Sequence[str]] = None) -> ConvergenceRun:
    """Run the CLI; returns the stage's ConvergenceRun."""
    args = build_parser().parse_args(argv)
    return run_grpo(args) if args.grpo else run_base(args)


if __name__ == "__main__":
    main()

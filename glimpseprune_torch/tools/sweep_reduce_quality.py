"""Pair the reduce_layer latency sweep with a trained-fuser quality proxy;
counterpart of tools/sweep_reduce_quality.py.

``docs/sweep_reduce_layer.json`` measures the prefill ratio at
reduce_layer in {2, 6, 10, 14, 18} (of the 7B's 28 layers) but says
nothing of whether a fuser harvesting that early can still learn good
masks (the reference recipe trains at layer 18,
train_configs/qwen2_5_7b_gp/qwen2_5_7b_gp.yaml:43). This tool trains the
fuser at matched depth fractions on an 8-layer tiny config (layer
max(1, round(rl / 28 * 8)): 2 -> 1, 6 -> 2, 10 -> 3, 14 -> 4, 18 -> 5)
over the synthetic-boxes corpus and records the converged mask IoU beside
each latency row as ``iou_tiny8_proxy``.

Proxy caveats (kept in the JSON): tiny-scale random frozen base, synthetic
boxes; it probes "does an early harvest carry enough signal to train the
fuser", not the 7B's quality (no checkpoints here).

The 7B reduce layers come from ``--sweep`` (a latency sweep's JSON, read
only; its other fields are carried over) or from ``--layers``. The result
goes to ``--out`` (default: under ``--data-root``), never back into the
sweep file.

  python -m glimpseprune_torch.tools.sweep_reduce_quality --steps 300
  python -m glimpseprune_torch.tools.sweep_reduce_quality --layers 2,18 --steps 10 \\
      --device cpu
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import tempfile
from typing import Optional, Sequence

import numpy as np

N_7B_LAYERS = 28  # the latency sweep ran on the 7B's 28 layers


def tiny8_config(reduce_layer: int):
    """The tiny test config with 8 decoder layers, harvesting and reducing
    at ``reduce_layer``, glimpse embeddings on every layer."""
    from glimpseprune_torch.config import tiny_test_config

    cfg = tiny_test_config()
    text = dataclasses.replace(cfg.text, num_hidden_layers=8)
    gp = dataclasses.replace(cfg.gp, selected_layers=(reduce_layer,),
                             reduce_layer=reduce_layer, le_layers=tuple(range(8)))
    return dataclasses.replace(cfg, text=text, gp=gp)


def tiny8_layer(reduce_layer_7b: int) -> int:
    """The 8-layer config's layer at the 7B layer's depth fraction."""
    return max(1, round(reduce_layer_7b / N_7B_LAYERS * 8))


def train_one(reduce_layer: int, steps: int, lr: float, data_cfg, img_dir: str,
              out_dir: str, seed: int = 0, device: str = "cuda") -> dict:
    """Train a tiny8 model's fuser harvesting at reduce_layer for ``steps``
    steps (batch 2) -> its row of results: the mean IoU and loss over the
    history rows of the last 50 steps, the first loss."""
    import torch

    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.tools.common import resolve_device
    from glimpseprune_torch.tools.convergence_run import tiny_tokenize
    from glimpseprune_torch.training.data import GPDataset
    from glimpseprune_torch.training.trainer import GPTrainer, TrainerConfig

    cfg = tiny8_config(reduce_layer)
    dev = resolve_device(device)
    # the frozen base in bf16 on a card (the kernels' dtype), fp32 on the CPU
    model = init_random(cfg, seed, dev, torch.bfloat16 if dev.type == "cuda" else torch.float32)
    dataset = GPDataset(data_cfg, img_dir=img_dir, tokenize=tiny_tokenize)
    tcfg = TrainerConfig(
        learning_rate=lr, batch_size=2, num_epochs=1000, log_every=10,
        save_every=0, output_dir=out_dir, seq_multiple=8, patch_multiple=16,
    )
    trainer = GPTrainer(cfg, model, dataset, tiny_tokenize, tcfg=tcfg)
    history = trainer.train(max_steps=steps)
    tail = [h for h in history if h["step"] > steps - 50]
    return {
        "tiny8_layer": reduce_layer,
        "iou_tiny8_proxy": round(float(np.mean([h["mask_iou"] for h in tail])), 4),
        "final_loss": round(float(np.mean([h["loss"] for h in tail])), 4),
        "first_loss": round(float(history[0]["loss"]), 4),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns the sweep it writes."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-samples", type=int, default=128)
    ap.add_argument("--sweep", default="docs/sweep_reduce_layer.json",
                    help="latency sweep whose rows' reduce_layer to pair (read only)")
    ap.add_argument("--layers", default=None,
                    help="comma-separated 7B reduce layers, instead of --sweep's rows")
    ap.add_argument("--data-root", default=os.path.join(tempfile.gettempdir(),
                                                        "sweep_quality_data"))
    ap.add_argument("--out", default=None,
                    help="result JSON (default DATA_ROOT/sweep_reduce_layer.json)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from glimpseprune_torch.tools.common import resolve_device
    from glimpseprune_torch.tools.convergence_run import make_synth_corpus

    resolve_device(args.device)
    os.makedirs(args.data_root, exist_ok=True)
    out = args.out or os.path.join(args.data_root, "sweep_reduce_layer.json")
    data_cfg, img_dir = make_synth_corpus(args.data_root, args.n_samples, 96)
    if args.layers:
        sweep = {"rows": [{"reduce_layer": int(x)} for x in args.layers.split(",")]}
    else:
        with open(args.sweep) as f:
            sweep = copy.deepcopy(json.load(f))

    results = []
    for row in sweep["rows"]:
        rl7 = row["reduce_layer"]
        l8 = tiny8_layer(rl7)
        print(f"reduce_layer {rl7}/{N_7B_LAYERS} -> tiny8 layer {l8}/8: training "
              f"{args.steps} steps...", flush=True)
        r = train_one(l8, args.steps, args.lr, data_cfg, img_dir,
                      os.path.join(args.data_root, f"ckpt_tiny8_l{l8}"), args.seed,
                      args.device)
        row.update(r)
        results.append({**r, "reduce_layer_7b": rl7})
        print(f"  -> IoU {r['iou_tiny8_proxy']} "
              f"(loss {r['first_loss']} -> {r['final_loss']})", flush=True)

    sweep["iou_proxy_note"] = (
        "iou_tiny8_proxy: converged mask IoU of a fuser trained to harvest "
        "at the depth-fraction-matched layer of an 8-layer tiny config "
        "(synthetic-boxes corpus, random frozen base, %d steps) — a "
        "trainability probe for early harvests, NOT a 7B quality "
        "measurement (no checkpoints in this environment)." % args.steps
    )
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(sweep, f, indent=1)
    print(json.dumps(results, indent=1))
    print(f"written to {out}")
    return sweep


if __name__ == "__main__":
    main()

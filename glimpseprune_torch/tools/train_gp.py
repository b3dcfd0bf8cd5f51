"""Train the GlimpsePrune modules (base recipe) — the reference
train_qwen_gp.py CLI; counterpart of tools/train_gp.py.

The base model is frozen; ``GPTrainer`` trains the new modules and saves
them (``new_modules_gp.pt``, ``config.json``, the optimizer state and the
metric history) into ``--output-dir``. Configs are YAML, or JSON when the
file ends in ``.json``: ``--config`` holds TrainerConfig keys,
``--data-config`` the dataset entries (``training/data.py``). Images may
be ``.npy`` arrays.

  python -m glimpseprune_torch.tools.train_gp --config configs/qwen2_5_3b_gp.yaml \\
      --hf-model /path/Qwen2.5-VL-3B-Instruct --data-config data.yaml \\
      --img-dir /data/images --output-dir ckpt/gp
  python -m glimpseprune_torch.tools.train_gp --model-config configs/model_qwen2_5_7b_gp \\
      --seed 0 --data-config data.json --img-dir imgs --max-steps 2   # random 7B

``--mesh``: in a process of an initialized ``torch.distributed`` group of
more than one rank (every rank runs this CLI with the same arguments),
the (data, model) mesh of ``parallel.make_mesh()``: the model's weights
sharded over its model axis, each batch split over its data axis, the
checkpoint written by the first rank. Without such a group it says so and
trains unsharded (JAX tools/train_gp.py:65-70).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Run the CLI; returns the checkpoint directory."""
    from glimpseprune_torch.tools.common import add_model_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None, help="trainer config (TrainerConfig keys)")
    ap.add_argument("--data-config", required=True, help="dataset config")
    ap.add_argument("--img-dir", default="")
    ap.add_argument("--output-dir", default="checkpoints/gp")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--resume-from", default=None,
                    help="checkpoint dir: reload new modules + opt state and "
                    "continue the step count (reference --resume_from_checkpoint, "
                    "train_qwen_gp.py:1601-1608,1968)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard over the (data, model) mesh of the process group's ranks")
    add_model_args(ap)
    args = ap.parse_args(argv)

    from glimpseprune_torch.evalsuite.data import load_image
    from glimpseprune_torch.tools.common import load_model, read_config, text_codec
    from glimpseprune_torch.training.data import GPDataset
    from glimpseprune_torch.training.trainer import GPTrainer, TrainerConfig

    tcfg = TrainerConfig(**{**read_config(args.config), "output_dir": args.output_dir})
    cfg, model, tok = load_model(args)
    tokenize, _ = text_codec(tok)
    dataset = GPDataset(read_config(args.data_config), img_dir=args.img_dir, tokenize=tokenize)
    print(f"dataset: {len(dataset)} samples")
    mesh = None
    if args.mesh:
        import torch.distributed as dist

        from glimpseprune_torch.parallel import make_mesh, shard_params

        if dist.is_initialized() and dist.get_world_size() > 1:
            mesh = make_mesh()
            shard_params(model, mesh)
            print(f"mesh: {mesh.shape} (rank {dist.get_rank()}: data {mesh.data_index}, "
                  f"model {mesh.model_index})")
        else:
            print("mesh: no process group of more than one rank; training unsharded")
    trainer = GPTrainer(cfg, model, dataset, tokenize, load_image=load_image, tcfg=tcfg,
                        resume_from=args.resume_from, mesh=mesh)
    history = trainer.train(max_steps=args.max_steps)
    print(f"final metrics: {json.dumps(history[-1] if history else {})}")
    out = trainer.save()
    print(f"checkpoint: {out}")
    return out


if __name__ == "__main__":
    main()

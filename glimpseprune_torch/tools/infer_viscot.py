"""Free-form VisCoT inference CLI (reference viscot_eval/infer_cot.py);
counterpart of tools/infer_viscot.py.

Runs generate / glimpse over a benchmark JSON with a GlimpsePrune (or
baseline-compressed) model, writing <dataset>_<task>.jsonl and
<dataset>_<task>_info.json with mask metrics and per-call times. Several
hosts: --host-id/--num-hosts take contiguous shards. Images may be ``.npy``
arrays.

  python -m glimpseprune_torch.tools.infer_viscot --benchmark gqa.json \\
      --img-dir /data/images --hf-model /path/Qwen2.5-VL-7B-Instruct \\
      --new-modules ckpt/gp --task generate --max-remain-ratio 0.111 --out-dir results/gqa
  python -m glimpseprune_torch.tools.infer_viscot --benchmark bench.json --img-dir imgs \\
      --model-config configs/model_qwen2_5_7b_gp --seed 0 --new-modules ckpt/gp \\
      --out-dir results   # random 7B
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Run the CLI; returns the results jsonl path."""
    from glimpseprune_torch.tools.common import add_model_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--benchmark", required=True, help="VisCoT benchmark json")
    ap.add_argument("--img-dir", required=True)
    ap.add_argument("--dataset-name", default=None)
    ap.add_argument("--mapper", default="cot_bench")
    ap.add_argument("--task", default="generate", choices=["generate", "glimpse"])
    ap.add_argument("--compressor", default=None,
                    help="baseline method instead of GP (visionzip/divprune/...)")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--max-new-tokens", type=int, default=1024)
    ap.add_argument("--max-remain-ratio", type=float, default=None)
    ap.add_argument("--min-remain-num", type=int, default=None)
    ap.add_argument("--reduce-layer", type=int, default=None)
    ap.add_argument("--use-ref-masks", action="store_true")
    ap.add_argument("--no-selection", action="store_true")
    ap.add_argument("--no-brief", action="store_true")
    ap.add_argument("--num-samples", type=int, default=None)
    ap.add_argument("--save-masks", action="store_true")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--overwrite", action="store_true")
    add_model_args(ap)
    args = ap.parse_args(argv)

    from glimpseprune_torch.evalsuite import (
        InferenceConfig,
        load_benchmark,
        run_inference,
        shard_for_host,
    )
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.tools.common import load_model, text_codec

    name = args.dataset_name or os.path.splitext(os.path.basename(args.benchmark))[0]
    if args.num_hosts > 1:
        name = f"{name}_shard{args.host_id}"
    task = args.task
    out_path = os.path.join(args.out_dir, f"{name}_{task}.jsonl")
    if os.path.exists(out_path) and not args.overwrite:
        print(out_path)  # skip-if-done, before the model is built
        return out_path

    gp_overrides = {k: v for k, v in (("max_remain_ratio", args.max_remain_ratio),
                                      ("min_remain_num", args.min_remain_num),
                                      ("reduce_layer", args.reduce_layer)) if v is not None}
    cfg, model, tok = load_model(args, gp_overrides)
    runner = GlimpsePruneRunner(cfg, model)
    samples = load_benchmark(
        args.benchmark, args.img_dir, mapper=args.mapper,
        brief=not args.no_brief, num_samples=args.num_samples,
    )
    samples = shard_for_host(samples, args.host_id, args.num_hosts)
    icfg = InferenceConfig(
        task=task,
        batch_size=args.batch_size,
        max_new_tokens=args.max_new_tokens,
        use_ref_masks=args.use_ref_masks,
        do_selection=not args.no_selection,
        brief=not args.no_brief,
        save_masks=args.save_masks,
        compressor=args.compressor,
    )
    tokenize, detokenize = text_codec(tok)
    out = run_inference(runner, samples, args.out_dir, name, icfg, tokenize=tokenize,
                        detokenize=detokenize, overwrite=args.overwrite)
    print(out)
    return out


if __name__ == "__main__":
    main()

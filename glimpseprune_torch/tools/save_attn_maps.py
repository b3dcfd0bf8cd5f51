"""Dump glimpse attention heatmaps blended on the image; counterpart of
tools/save_attn_maps.py (reference save_seq_attns.py).

Writes, under ``--out-dir``:
- ``fused_map_{i}.png``: the fuser's mask logits of output i (sigmoid,
  min-max normalized), as JAX's tool writes them;
- ``attn_l{l}_mean.png`` and, with ``--per-head``, ``attn_l{l}_h{h}.png``:
  the glimpse query's attention over the image tokens at each layer of
  ``--layers`` (default the config's selected_layers; ``runner.harvest_rows``),
  head-mean or one head;
- with ``--q-start S``: ``seq_attns_layer{l}.npz`` ([n_query, n_img, heads]
  softmax rows of every query from S on) and ``seq_attn_l{l}_q{k}.png``
  (head-mean), as JAX's tool writes them.

A heatmap [gh, gw] is scaled up by whole pixels and blended as JAX blends
it (image * 0.4 + (255 h, 80 h, 80 - 80 h) * 0.6); PNGs come from
``utils/viz.encode_png``, so no PIL is needed but to open an image that is
not ``.npy``. ``main`` returns the heatmaps by file name.

  python -m glimpseprune_torch.tools.save_attn_maps --image img.npy --question "hi" \\
      --model-config configs/model_qwen2_5_7b_gp --seed 0 --per-head --native-preproc
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def normalize(amap: np.ndarray) -> np.ndarray:
    return (amap - amap.min()) / max(amap.max() - amap.min(), 1e-6)


def blend(image: np.ndarray, amap: np.ndarray) -> np.ndarray:
    """The normalized heatmap amap [gh, gw] blended on image [H, W, 3]
    (JAX save_attn_maps.py:111-113)."""
    h, w = image.shape[:2]
    gh, gw = amap.shape
    heat = np.kron(amap, np.ones((h // gh + 1, w // gw + 1)))[:h, :w]
    out = image * 0.4 + np.stack([heat * 255, heat * 80, 80 - heat * 80], -1) * 0.6
    return out.astype(np.uint8)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns {"files": [...], "heatmaps": {file: [gh, gw]},
    "harvest_sums": {layer: max over heads of the attention summed over the
    image tokens}, "seq_harvest_sums": likewise for the q_start rows}."""
    from glimpseprune_torch.tools.common import add_model_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", required=True, help=".npy [H, W, 3] uint8, or any PIL image")
    ap.add_argument("--question", required=True)
    ap.add_argument("--layers", type=int, nargs="*", default=None,
                    help="decoder layers to dump (default: the config's selected_layers)")
    ap.add_argument("--per-head", action="store_true", help="one map per head too")
    ap.add_argument("--q-start", type=int, default=None,
                    help="also dump the multi-query maps of every query position from this "
                    "index on (reference model_sep.py:53-72); a negative index counts from "
                    "the padded sequence's end")
    ap.add_argument("--native-preproc", action="store_true",
                    help="prepare_inputs(use_native_preproc=True): resize without PIL")
    ap.add_argument("--out-dir", default="attn_maps")
    add_model_args(ap)
    args = ap.parse_args(argv)

    from glimpseprune_torch.evalsuite.data import load_image
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.tools.common import load_model, text_codec
    from glimpseprune_torch.utils.viz import encode_png

    cfg, model, tok = load_model(args)
    tokenize, _ = text_codec(tok)
    # --layers widens the harvest only: the fuser keeps selected_layers
    layers = tuple(args.layers) if args.layers else tuple(cfg.gp.selected_layers)
    image = load_image(args.image)
    prompt = ([cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id]
              + tokenize(args.question))
    prep = prepare_inputs(cfg, [prompt], [image], seq_multiple=8, patch_multiple=16,
                          use_native_preproc=args.native_preproc or None)
    runner = GlimpsePruneRunner(cfg, model)
    os.makedirs(args.out_dir, exist_ok=True)
    gh = int(prep.grids[0][1] // cfg.vision.spatial_merge_size)
    gw = int(prep.grids[0][2] // cfg.vision.spatial_merge_size)
    n = gh * gw
    out = {"files": [], "heatmaps": {}, "harvest_sums": {}, "seq_harvest_sums": {},
           "grid": [gh, gw]}

    def write(name: str, amap: np.ndarray) -> None:
        path = os.path.join(args.out_dir, name)
        with open(path, "wb") as f:
            f.write(encode_png(blend(image, amap)))
        out["files"].append(name)
        out["heatmaps"][name] = amap
        print(path)

    mask_logits, _ = runner.glimpse_delayed(prep)
    ml = mask_logits.float().cpu().numpy()  # [n_out, 1, N]
    for i in range(ml.shape[0]):
        write(f"fused_map_{i}.png",
              normalize(1 / (1 + np.exp(-ml[i, 0, :n])).reshape(gh, gw)))

    for layer, rows in runner.harvest_rows(prep, layers=layers).items():
        rows = rows[0, :n].float().cpu().numpy()  # [N, Hq]: log-probs, or raw logits
        probs = rows if cfg.gp.use_attention_logits else np.exp(rows)
        if not cfg.gp.use_attention_logits:
            out["harvest_sums"][int(layer)] = float(probs.sum(0).max())
        write(f"attn_l{layer}_mean.png", normalize(probs.mean(-1).reshape(gh, gw)))
        if args.per_head:
            for h in range(probs.shape[1]):
                write(f"attn_l{layer}_h{h}.png", normalize(probs[:, h].reshape(gh, gw)))

    if args.q_start is not None:
        q_start = args.q_start % prep.input_ids.shape[1]
        for layer, rows in runner.harvest_rows(prep, layers=layers, q_start=q_start).items():
            r = rows[0].float().cpu().numpy()  # [n_q, N_img, Hq]
            npz = os.path.join(args.out_dir, f"seq_attns_layer{layer}.npz")
            np.savez_compressed(npz, attns=r, grid_hw=np.array([gh, gw]))
            out["files"].append(os.path.basename(npz))
            out["seq_harvest_sums"][int(layer)] = float(r[:, :n].sum(1).max())
            mean = r[:, :n].mean(-1)  # [n_q, N]
            for qi in range(mean.shape[0]):
                write(f"seq_attn_l{layer}_q{qi:03d}.png", normalize(mean[qi].reshape(gh, gw)))
            print(f"layer {layer}: {mean.shape[0]} query maps")
    return out


if __name__ == "__main__":
    main()

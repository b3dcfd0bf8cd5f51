"""One-shot GlimpsePrune demo (CLI version of reference demo_gp.py);
counterpart of tools/demo.py.

Loads a model, answers one question about one image, and shows the
kept-token mask as ASCII (and, with --overlay, a dimmed-overlay PNG, for
which PIL is imported then). Images may be ``.npy`` arrays. ``--int8``
serves the model's weights in int8, weight-only (``quantize_model`` after
any ``--new-modules``, as the JAX demo orders it).

  python -m glimpseprune_torch.tools.demo --image cat.jpg --question "What is on the table?" \\
      --hf-model /path/Qwen2.5-VL-7B-Instruct --new-modules ckpt/gp --overlay out.png
  python -m glimpseprune_torch.tools.demo --image img.npy --question "hi" \\
      --model-config configs/model_qwen2_5_7b_gp --seed 0 --stream   # random 7B
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI; returns the GenerateResult."""
    from glimpseprune_torch.tools.common import add_model_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", required=True)
    ap.add_argument("--question", required=True)
    ap.add_argument("--max-remain-ratio", type=float, default=0.111)
    ap.add_argument("--reduce-threshold", type=float, default=0.5)
    ap.add_argument("--no-selection", action="store_true")
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--overlay", default=None, help="write dimmed-mask PNG here")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 serving (the model quantized after --new-modules)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they decode (reference demo_gp.py "
                    "TextIteratorStreamer); implies do_selection")
    ap.add_argument("--stream-chunk", type=int, default=4,
                    help="tokens per streamed increment (1 = per-token)")
    add_model_args(ap)
    args = ap.parse_args(argv)

    from glimpseprune_torch.evalsuite.data import load_image
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.tools.common import load_model, text_codec
    from glimpseprune_torch.utils.viz import apply_mask_on_image, ascii_mask

    cfg, model, tok = load_model(args, dict(max_remain_ratio=args.max_remain_ratio,
                                            reduce_threshold=args.reduce_threshold))
    tokenize, detokenize = text_codec(tok)
    if args.int8:
        from glimpseprune_torch.quantization import quantize_model, quantized_config

        cfg = quantized_config(cfg, "int8")
        quantize_model(model, "int8", cfg=cfg)

    image = load_image(args.image)
    prompt = ([cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id]
              + tokenize(args.question))
    prep = prepare_inputs(cfg, [prompt], [image], seq_multiple=8, patch_multiple=16)
    runner = GlimpsePruneRunner(cfg, model)
    print(f"\nQ: {args.question}")
    if args.stream:
        print("A: ", end="", flush=True)
        gen = runner.stream_generate(prep, max_new_tokens=args.max_new_tokens,
                                     chunk_size=args.stream_chunk)
        while True:
            try:
                toks = next(gen)
            except StopIteration as stop:
                res = stop.value
                break
            piece = [int(x) for x in toks[0] if int(x) != cfg.eos_token_id]
            if piece:
                print(detokenize(piece), end=" ", flush=True)
        print()
    else:
        res = runner.generate(prep, max_new_tokens=args.max_new_tokens,
                              do_selection=not args.no_selection)
        print(f"A: {detokenize(res.sequences[0, : res.num_generated[0]])}")
    if res.keep_img is not None:
        gh = int(prep.grids[0][1] // cfg.vision.spatial_merge_size)
        gw = int(prep.grids[0][2] // cfg.vision.spatial_merge_size)
        mask = res.keep_img[0, : gh * gw].reshape(gh, gw)
        print(f"\npruned {res.prune_ratio[0]*100:.1f}% of {gh*gw} visual tokens; kept mask:")
        print(ascii_mask(mask))
        if args.overlay:
            from PIL import Image

            Image.fromarray(apply_mask_on_image(image, mask)).save(args.overlay)
            print(f"overlay written to {args.overlay}")
    return res


if __name__ == "__main__":
    main()

"""Profile one GlimpsePrune train step at a chosen image size (the
long-context axis); counterpart of tools/profile_train_step.py.

The reference trains at max_pixels 12845056 (~16.4k image tokens,
train_qwen_gp.py:1645-1648). This runs the port's train step
(``training/train_step.make_train_step``) on one row with an image of
``--img-side`` pixels, with the decoder's remat forced as ``GPTrainer``
forces it, ``--steps`` times: step ms (CUDA events) and the peak
(``max_memory_allocated``) take the place of XLA's ``memory_analysis``.
The base is random: in ``--quant int8`` (the default) int8 weights drawn
straight into the model (``utils/fastinit.device_random_params``; weight-only,
as JAX's tool quantizes), the GlimpsePrune modules trained in fp32.
``--fallback-sides 3584,2688,1792`` runs the step through
``utils/failures.with_oom_fallback``: a side that runs out of memory gives
way to the next, and the side that ran and each OOM before it are printed
and returned.

  python -m glimpseprune_torch.tools.profile_train_step --img-side 3584 \\
      --fallback-sides 3584,2688,1792 --json
  python -m glimpseprune_torch.tools.profile_train_step --scale tiny --device cpu \\
      --img-side 96 --quant ''
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

PROMPT_TEXT = ([5, 6], [7, 8])  # text ids before and after the image marker (JAX's)
ANSWER = [9, 10, 11, 12]
BOX = [[0.2, 0.2, 0.5, 0.5]]


def train_batch(cfg, side: int, max_pixels: int, dev, native: Optional[bool] = None,
                tiny: bool = False):
    """(prep, batch dict) of one row with a random side x side image (seed
    0), JAX's prompt, answer and box, padded as JAX pads the tiny config
    (``tiny``) and the others."""
    import numpy as np

    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.training.trainer import batch_from_prep

    img = np.random.default_rng(0).integers(0, 255, (side, side, 3), dtype=np.uint8)
    prompt = (PROMPT_TEXT[0] + [cfg.vision_start_token_id, cfg.image_token_id,
                                cfg.vision_end_token_id] + PROMPT_TEXT[1])
    prep = prepare_inputs(cfg, [prompt], [img], normed_bboxes=[BOX], answer_ids=[ANSWER],
                          max_pixels=max_pixels or None, seq_multiple=8 if tiny else 64,
                          patch_multiple=16 if tiny else 256, use_native_preproc=native)
    return prep, batch_from_prep(prep, dev)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the profile; returns the record it prints."""
    from glimpseprune_torch.tools.common import add_profile_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_profile_args(ap, quant_default="int8")
    ap.add_argument("--img-side", type=int, default=3584,
                    help="3584 px ~ 16.4k image tokens (the reference's regime)")
    ap.add_argument("--max-pixels", type=int, default=12845056,
                    help="smart_resize cap (the reference's training cap)")
    ap.add_argument("--fallback-sides", default=None,
                    help="comma-separated sides tried in turn on OOM, e.g. 3584,2688,1792")
    ap.add_argument("--native-preproc", action="store_true",
                    help="prepare_inputs(use_native_preproc=True): resize without PIL")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-4)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from glimpseprune_torch.tools.common import emit, peak_gib, profile_model, reset_peak, sync
    from glimpseprune_torch.training.train_step import AdamW, init_trainable, make_train_step
    from glimpseprune_torch.utils.failures import with_oom_fallback

    def remat(c):  # the trainer always rematerializes (trainer.py, GPTrainer)
        return dataclasses.replace(c, text=dataclasses.replace(c.text, remat=True))

    cfg, model, dev = profile_model(args, args.quant, cfg_edit=remat, weights_only=True)
    trainable = init_trainable(model)
    start = {k: p.detach().clone() for k, p in trainable.items()}
    ooms = []

    def run(side: int) -> dict:
        with torch.no_grad():  # every side starts from the same modules
            for k, p in trainable.items():
                p.copy_(start[k])
        prep, batch = train_batch(cfg, side, args.max_pixels, dev, args.native_preproc or None,
                                  args.scale == "tiny")
        n_img = int(prep.n_img_tokens[0])
        print(f"image {side}px -> {n_img} image tokens, seq {prep.input_ids.shape[1]}, packed "
              f"patches {prep.patches.shape[0]}")
        step = make_train_step(cfg, model, AdamW(trainable, args.lr))
        gen = torch.Generator(device=dev).manual_seed(1)
        reset_peak(dev)
        times, losses = [], []
        for i in range(args.steps):
            if dev.type == "cuda":
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
            else:
                h0 = time.perf_counter()
            metrics = step(batch, gen)
            loss = float(metrics["loss"])  # reads the step's result back
            if dev.type == "cuda":
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1))
            else:
                times.append(1e3 * (time.perf_counter() - h0))
            losses.append(loss)
            print(f"step {i}: {times[-1]:.1f} ms loss={loss:.4f}")
        sync(dev)
        steady = times[1:] or times
        return {"img_side": side, "n_visual_tokens": n_img, "seq": int(prep.input_ids.shape[1]),
                "packed_patches": int(prep.patches.shape[0]), "step_ms": times,
                "losses": losses, "train_step_s": min(steady) / 1e3,
                "train_step_median_s": float(np.median(steady)) / 1e3,
                "peak_gib": peak_gib(dev)}

    sides = ([int(x) for x in args.fallback_sides.split(",")] if args.fallback_sides
             else [args.img_side])
    runner = with_oom_fallback([{"side": s} for s in sides[1:]],
                               on_fallback=lambda i, e: ooms.append(
                                   {"side": sides[i], "error": str(e).splitlines()[0][:200]}))(run)
    out = runner(side=sides[0])
    oom_sides = [s for s in sides[: sides.index(out["img_side"])]]
    rec = {**out, "quant": args.quant, "scale": args.scale, "remat": True,
           "oom_sides": oom_sides, "ooms": ooms,
           "losses_finite": bool(np.isfinite(out["losses"]).all())}
    print(f"steady step: {out['train_step_s']:.3f} s (median {out['train_step_median_s']:.3f} s) "
          f"at {out['n_visual_tokens']} image tokens, side {out['img_side']}"
          + (f" after OOM at {oom_sides}" if oom_sides else "") + "; peak "
          + ("not measured (CPU)" if rec["peak_gib"] is None else f"{rec['peak_gib']:.2f} GiB"))
    return emit(rec, args.json)


if __name__ == "__main__":
    main()

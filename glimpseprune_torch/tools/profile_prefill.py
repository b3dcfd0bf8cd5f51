"""Profile the pruned prefill stage by stage; counterpart of
tools/profile_prefill.py.

Times, on one image of side sqrt(1.3 * max_pixels) (4086 at the bench's
max_pixels 12845056: ~16k image tokens), three nested stages of the pruned
prefill: the ViT (``vision_encode``), the ViT plus ``glimpse_encode``
(layers 0..reduce_layer, the harvest, the fuser), and the whole pruned
prefill (the keep policy, the compaction and the resumed layers), then two
yardsticks at the prefill's S: one layer's causal flash attention (K2) and
one layer's matmuls (``torch.matmul``). It prints the breakdown and the
per-layer line, S, the image tokens, the packed patches, the kept tokens,
the host's ``prepare_inputs`` ms and the peak (``max_memory_allocated``);
``--vision`` adds the ViT's own split (one windowed block, one full-
attention block, K2 alone at the packed patch shape, the block's matmuls,
the patch embedding, the merger). Times are CUDA events, the median of
``--iters`` after a warm-up.

  python -m glimpseprune_torch.tools.profile_prefill --quant int8 \\
      --max-pixels 12845056 --native-preproc            # the 16k image, (q8)
  python -m glimpseprune_torch.tools.profile_prefill --scale tiny --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def profile_vision(cfg, model, inputs, prep, dev, iters: int) -> dict:
    """The ViT's split at the real packed patch shape (JAX
    ``profile_vision``): one windowed block, one full-attention block, K2
    alone, one block's matmuls, the patch embedding and the merger, and
    their extrapolation to the tower."""
    import torch
    import torch.nn.functional as F

    from glimpseprune_torch.models.qwen2_5_vl.inputs import _vis_dense_hint
    from glimpseprune_torch.ops.cuda.flash_attention import flash_attention
    from glimpseprune_torch.ops.rope import vision_rope_cos_sin
    from glimpseprune_torch.tools.common import time_ms

    v, vis = cfg.vision, model.visual
    p = inputs["patches"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((p, v.hidden_size), generator=gen, device=dev).to(model.dtype)
    cos, sin = vision_rope_cos_sin(inputs["vis_pos_ids"], v.head_dim)
    cos, sin = cos.to(model.dtype), sin.to(model.dtype)
    seg, valid = inputs["full_seg"], inputs["vis_valid"]
    dense = _vis_dense_hint(prep)
    block = vis.blocks[0]
    out = {}
    out["windowed_block_ms"] = time_ms(
        lambda: block(x, cos, sin, seg, valid, vis.window_patches), dev, iters)
    out["full_block_ms"] = time_ms(
        lambda: block(x, cos, sin, seg, valid, 0, dense_attn=dense), dev, iters)
    q = torch.randn((1, v.num_heads, p, v.head_dim), generator=gen, device=dev).to(model.dtype)
    s = None if dense else seg[None].to(torch.int32)
    out["flash_full_ms"] = time_ms(
        lambda: flash_attention(q, q, q, s, s, causal=False, dense=dense), dev, iters)
    out["flash_full_tflops"] = 4 * p * p * v.num_heads * v.head_dim / (
        out["flash_full_ms"] * 1e-3) / 1e12

    def matmuls():
        a = block.attn.qkv(x)
        m = block.mlp.down_proj(block.mlp.gate_proj(x) * block.mlp.up_proj(x))
        return a, m, block.attn.proj(x)

    out["block_matmuls_ms"] = time_ms(matmuls, dev, iters)
    out["patch_embed_ms"] = time_ms(lambda: vis.patch_embed(inputs["patches"]), dev, iters)
    mu = v.spatial_merge_unit

    def merger():
        m = vis.merger_ln_q(x).reshape(-1, mu * v.hidden_size)
        return vis.merger_fc2(F.gelu(vis.merger_fc1(m)))

    out["merger_ms"] = time_ms(merger, dev, iters)
    n_full = len(v.fullatt_block_indexes)
    n_win = v.depth - n_full
    out["extrapolated_ms"] = (out["patch_embed_ms"] + n_win * out["windowed_block_ms"]
                              + n_full * out["full_block_ms"] + out["merger_ms"])
    print(f"  vision: embed {out['patch_embed_ms']:.2f} + {n_win} windowed x "
          f"{out['windowed_block_ms']:.2f} ms + {n_full} full x {out['full_block_ms']:.2f} ms "
          f"+ merger {out['merger_ms']:.2f} ms = {out['extrapolated_ms']:.1f} ms; block "
          f"matmul floor {v.depth * out['block_matmuls_ms']:.1f} ms; K2 alone "
          f"{out['flash_full_ms']:.2f} ms ({out['flash_full_tflops']:.0f} TFLOP/s)")
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the profile; returns the record it prints."""
    from glimpseprune_torch.tools.common import add_profile_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_profile_args(ap)
    ap.add_argument("--max-pixels", type=int, default=1036 * 1036,
                    help="smart_resize cap; the image side is sqrt(1.3 * max_pixels)")
    ap.add_argument("--native-preproc", action="store_true",
                    help="prepare_inputs(use_native_preproc=True): resize without PIL")
    ap.add_argument("--vision", action="store_true", help="also split the ViT (JAX "
                    "PROFILE_VISION)")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.ops.cuda.flash_attention import flash_attention
    from glimpseprune_torch.tools.common import (
        emit,
        peak_gib,
        profile_model,
        reset_peak,
        text_ids,
        time_ms,
    )

    cfg, model, dev = profile_model(args, args.quant)
    rng = np.random.default_rng(0)
    side = int((args.max_pixels * 1.3) ** 0.5)
    img = rng.integers(0, 255, (side, side, 3), dtype=np.uint8)
    prompt = (text_ids(cfg, rng, 24) + [cfg.vision_start_token_id, cfg.image_token_id,
                                         cfg.vision_end_token_id] + text_ids(cfg, rng, 24))
    t0 = time.perf_counter()
    prep = prepare_inputs(cfg, [prompt], [img], max_pixels=args.max_pixels,
                          use_native_preproc=args.native_preproc or None)
    prep_ms = 1e3 * (time.perf_counter() - t0)
    s = prep.input_ids.shape[1]
    rec = {"quant": args.quant, "image_side": side, "S": int(s),
           "n_img_tokens": int(prep.n_img_tokens[0]), "packed_patches": int(prep.patches.shape[0]),
           "real_patches": int(prep.vis_valid.sum()), "out_len": int(prep.out_len),
           "prepare_inputs_ms": prep_ms, "native_preproc": bool(args.native_preproc)}
    print(f"image {side}x{side} -> S={s} n_img={rec['n_img_tokens']} patches="
          f"{rec['packed_patches']} ({rec['real_patches']} real) out_len={prep.out_len}; "
          f"prepare_inputs {prep_ms:.1f} ms")

    runner = GlimpsePruneRunner(cfg, model)
    reset_peak(dev)
    with torch.inference_mode():
        inputs = runner._device_inputs(prep)
        anchor = inputs["anchor_mask"]

        def vision():
            return runner._vision(inputs, prep)

        def encode():
            merged, taps = vision()
            return model.glimpse_encode(
                input_ids=inputs["input_ids"], valid=inputs["valid"],
                position_ids=inputs["position_ids"], image_embeds=merged, taps=taps,
                packed_idx=inputs["packed_idx"], img_slots=inputs["img_slots"],
                img_valid=inputs["img_valid"], fuser_window_index=inputs["fuser_window_index"],
                fuser_reverse_index=inputs["fuser_reverse_index"],
                fuser_segment_ids=inputs["fuser_segment_ids"],
                fuser_pos_ids=inputs["fuser_pos_ids"], le_start=inputs["le_start"],
                img_group=inputs["img_group"])

        def prefill():
            mask_logits, state, _ = encode()
            return model.reduce_and_resume(state, mask_logits, prep.out_len, anchor)

        rec["vision_encode_ms"] = time_ms(vision, dev, args.iters)
        rec["vision_glimpse_encode_ms"] = time_ms(encode, dev, args.iters)
        rec["pruned_prefill_ms"] = time_ms(prefill, dev, args.iters)
        out = prefill()
        rec["peak_gib"] = peak_gib(dev)
        kept = out.keep_img.sum(1).tolist()
        rec["kept_img_tokens"] = [int(k) for k in kept]
        rec["min_remain_num"] = int(cfg.gp.min_remain_num)
        rec["first_logits_finite"] = bool(torch.isfinite(out.logits.float()).all())
        if args.vision:
            rec["vision_split"] = profile_vision(cfg, model, inputs, prep, dev, args.iters)

        c = cfg.text
        gen = torch.Generator(device=dev).manual_seed(1)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(model.dtype)

        q = rand(1, c.num_attention_heads, s, c.head_dim)
        k, v = rand(1, c.num_key_value_heads, s, c.head_dim), rand(1, c.num_key_value_heads, s,
                                                                    c.head_dim)
        seg = torch.zeros((1, s), dtype=torch.int32, device=dev)
        rec["flash_attention_ms"] = time_ms(
            lambda: flash_attention(q, k, v, seg, seg, causal=True), dev, args.iters)
        del q, k, v
        h, i = c.hidden_size, c.intermediate_size
        kvd = 2 * c.num_key_value_heads * c.head_dim
        x, wq, wg, wd, wo = rand(s, h), rand(h, h + kvd), rand(h, 2 * i), rand(i, h), rand(h, h)

        def layer_matmuls():
            g = x @ wg
            return x @ wq, g, g[:, :i] @ wd, x @ wo

        rec["matmul_floor_ms"] = time_ms(layer_matmuls, dev, args.iters)
        flops = 2 * s * h * (h + kvd + 2 * i + h) + 2 * s * i * h
        rec["matmul_floor_tflops"] = flops / (rec["matmul_floor_ms"] * 1e-3) / 1e12
        del x, wq, wg, wd, wo

    n_layers, n_red = c.num_hidden_layers, min(cfg.gp.reduce_layer, c.num_hidden_layers - 1) + 1
    rec["glimpse_ms"] = rec["vision_glimpse_encode_ms"] - rec["vision_encode_ms"]
    rec["reduce_resume_ms"] = rec["pruned_prefill_ms"] - rec["vision_glimpse_encode_ms"]
    rec["glimpse_layer_ms"] = rec["glimpse_ms"] / n_red
    print(f"vision_encode {rec['vision_encode_ms']:.2f} ms | vision + glimpse_encode "
          f"{rec['vision_glimpse_encode_ms']:.2f} | pruned prefill {rec['pruned_prefill_ms']:.2f}"
          f" | flash_attention 1 layer S={s} {rec['flash_attention_ms']:.3f} | 1-layer matmul "
          f"floor {rec['matmul_floor_ms']:.3f} ({rec['matmul_floor_tflops']:.0f} TFLOP/s)")
    print(f"breakdown: vision {rec['vision_encode_ms']:.1f} ms | glimpse({n_red} layers) "
          f"{rec['glimpse_ms']:.1f} ms | reduce+resume({n_layers - n_red} layers) "
          f"{rec['reduce_resume_ms']:.1f} ms | total {rec['pruned_prefill_ms']:.1f} ms")
    print(f"per-layer glimpse: {rec['glimpse_layer_ms']:.2f} ms vs floor "
          f"{rec['matmul_floor_ms']:.2f} ms matmul + {rec['flash_attention_ms']:.2f} ms attention")
    print(f"kept {rec['kept_img_tokens']} of {rec['n_img_tokens']}; peak "
          + ("not measured (CPU)" if rec["peak_gib"] is None else f"{rec['peak_gib']:.2f} GiB"))
    return emit(rec, args.json)


if __name__ == "__main__":
    main()

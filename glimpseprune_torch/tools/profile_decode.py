"""Decode-step cost over the context length; counterpart of
tools/profile_decode.py.

Times the runner's decode step (one captured CUDA graph, replayed; the
step run eagerly on the CPU) over a preallocated cache of T slots at B = 1,
for T in ``--contexts`` (2048, 8192, 16896): the cache holds random values,
its last 32 slots are invalid, and 32 steps run into them. A least-squares
line through ms/step over T separates the context-proportional work (the
cache read, the attention over it) from the flat one (the weight read, the
head): the slope per 1k tokens of context, the bytes a step that slope
implies at the card's 3.35 TB/s, and the intercept beside the weight-read
floor. ``lm_head`` is timed alone with its bytes.

  python -m glimpseprune_torch.tools.profile_decode --quant int8 --kv-quant int8
  python -m glimpseprune_torch.tools.profile_decode --scale tiny --device cpu
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's memory rate
STEPS = 32


def _nbytes(module) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the profile; returns the record it prints."""
    from glimpseprune_torch.tools.common import add_profile_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_profile_args(ap)
    ap.add_argument("--kv-quant", default=None, choices=["", "int8"],
                    help="KV cache tier (default: int8 in a quantized tier, else none)")
    ap.add_argument("--contexts", type=int, nargs="+", default=[2048, 8192, 16896])
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.ops.kv_cache import alloc_cache, cache_nbytes, cache_set_prefix
    from glimpseprune_torch.tools.common import emit, profile_model, time_ms

    cfg, model, dev = profile_model(args, args.quant, args.kv_quant)
    runner = GlimpsePruneRunner(cfg, model)
    tc = cfg.text
    shape = (tc.num_hidden_layers, 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {"quant": args.quant, "kv_quant": tc.kv_cache_quant, "B": 1, "steps": STEPS,
           "contexts": []}
    with torch.inference_mode():
        logits = torch.randn((1, 1, tc.vocab_size), generator=gen, device=dev)
        for t in args.contexts:
            cache = []
            for _ in range(2):  # k, v: random values, written one layer at a time
                c = alloc_cache(shape + (t, tc.num_key_value_heads, tc.head_dim), model.dtype,
                                dev, tc.kv_cache_quant)
                for layer in range(tc.num_hidden_layers):
                    part = torch.randn((1, 1, t, tc.num_key_value_heads, tc.head_dim),
                                       generator=gen, device=dev).to(model.dtype)
                    cache_set_prefix({k: x[layer:layer + 1] for k, x in c.items()}
                                     if isinstance(c, dict) else c[layer:layer + 1], part)
                cache.append(c)
            r = t - STEPS
            r_valid = torch.ones((1, r), dtype=torch.bool, device=dev)
            r_pos = torch.arange(r, device=dev).expand(3, 1, r)

            def run():
                steps = runner.decode_steps(logits, r_valid, r_pos, cache[0], cache[1], t, -1,
                                            prealloc=True)
                steps.run(STEPS, None)

            ms = time_ms(run, dev, args.iters) / STEPS
            rec["contexts"].append({"T": t, "ms_per_step": ms,
                                    "cache_bytes": sum(cache_nbytes(c) for c in cache)})
            print(f"T={t:6d}: {ms:7.3f} ms/step  ({STEPS} steps, cache "
                  f"{rec['contexts'][-1]['cache_bytes'] / 1e9:.2f} GB)")
            del cache, c, part
        h = torch.zeros((1, 1, tc.hidden_size), dtype=model.dtype, device=dev)
        tied = tc.tie_word_embeddings
        head = model.text.embed_tokens if tied else model.text.lm_head
        rec["lm_head_ms"] = time_ms(lambda: model.text.logits(h), dev, max(args.iters, 5))
        rec["lm_head_bytes"] = _nbytes(head)
    ts = np.array([c["T"] for c in rec["contexts"]], np.float64)
    ms = np.array([c["ms_per_step"] for c in rec["contexts"]], np.float64)
    if len(ts) > 1:
        slope, intercept = np.polyfit(ts, ms, 1)
        rec["slope_ms_per_1k_ctx"] = float(slope * 1e3)
        rec["intercept_ms"] = float(intercept)
        rec["implied_bytes_per_1k_ctx"] = float(slope * 1e3 * 1e-3 * HBM_BYTES_PER_S)
        rec["implied_ctx_bytes_at_max_T"] = float(slope * ts.max() * 1e-3 * HBM_BYTES_PER_S)
    # a step reads every decoder weight and the head, and one row of the
    # embedding table (which is the head when they are tied)
    weights = _nbytes(model.text) - (0 if tied else _nbytes(model.text.embed_tokens))
    rec["weight_bytes"] = int(weights)
    rec["weight_read_floor_ms"] = weights / HBM_BYTES_PER_S * 1e3
    print(f"lm_head [{tc.hidden_size}x{tc.vocab_size}]: {rec['lm_head_ms']:.3f} ms "
          f"({rec['lm_head_bytes'] / 1e9:.2f} GB)")
    if "slope_ms_per_1k_ctx" in rec:
        print(f"slope {rec['slope_ms_per_1k_ctx']:.4f} ms per 1k tokens of context = "
              f"{rec['implied_bytes_per_1k_ctx'] / 1e9:.3f} GB a step per 1k at 3.35 TB/s "
              f"({rec['implied_ctx_bytes_at_max_T'] / 1e9:.2f} GB at T={int(ts.max())}); "
              f"intercept {rec['intercept_ms']:.3f} ms vs the weight-read floor "
              f"{rec['weight_read_floor_ms']:.3f} ms ({weights / 1e9:.2f} GB)")
    return emit(rec, args.json)


if __name__ == "__main__":
    main()

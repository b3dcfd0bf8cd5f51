"""Time and memory of the GlimpsePrune+ (GRPO) update step; counterpart of
tools/profile_grpo_step.py.

Runs the real GRPO loss step (``training/grpo.make_grpo_loss_step``) on
N = ``--rows`` policy rows of R = ``--prompt-len`` pruned-prompt embeddings
and Tc = ``--completion-len`` completion tokens. The policy is the frozen
base (``--quant int8``: int8 weights drawn straight into the model,
weight-only, as JAX's tool quantizes) with fp32 LoRA adapters of rank
``--rank`` on every decoder projection and the decoder's remat on, as
``GRPOTrainer`` sets it. Two ways of computing the completion logprobs are
measured, each from the same adapters:

- chunked: ``gp_model.completion_logprobs`` (``chunked_token_logprobs``:
  the head over the completion's positions in chunks, no [N, Tc, V]
  logits kept), the shipped path;
- naive: ``completion_logits`` ([N, R + Tc, V] logits) + ``token_logprobs``,
  the reference's torch path (train_qwen_gp.py:1273-1339);

and the same two for the adapter-disabled reference logprobs
(``compute_ref_logps``). Each row holds ms (CUDA events, the median of
``--iters`` after a first call) and the peak (``max_memory_allocated``), or
"oom" where it ran out of memory, which is a result. Where both step rows
ran, their losses (the first call's, from the same adapters) must agree.

  python -m glimpseprune_torch.tools.profile_grpo_step --json
  python -m glimpseprune_torch.tools.profile_grpo_step --scale tiny --device cpu \\
      --rows 2 --prompt-len 16 --completion-len 8
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

ADAPTER_B_STD = 1e-3  # B drawn non-zero, so that the policy differs from the reference
KD_WEIGHT = 0.04


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the profile; returns the record it prints."""
    from glimpseprune_torch.tools.common import add_profile_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_profile_args(ap, quant_default="int8")
    ap.add_argument("--rows", type=int, default=16,
                    help="N = B*G policy rows (per-device batch x num_generations)")
    ap.add_argument("--prompt-len", type=int, default=2048,
                    help="R: the pruned prompt's length (16.4k image tokens pruned ~92%% "
                    "+ text ~ 1.3-2k)")
    ap.add_argument("--completion-len", type=int, default=256)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--iters", type=int, default=2)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from glimpseprune_torch.models.layers import lora_disabled
    from glimpseprune_torch.tools.common import (
        emit,
        peak_gib,
        profile_model,
        reset_peak,
        text_ids,
        time_ms,
    )
    from glimpseprune_torch.training.grpo import (
        GRPOBatch,
        compute_ref_logps,
        grpo_surrogate,
        k3_kl,
        make_grpo_loss_step,
        token_logprobs,
    )
    from glimpseprune_torch.training.lora import insert_lora, lora_parameters, make_lora_params
    from glimpseprune_torch.training.train_step import AdamW
    from glimpseprune_torch.utils.failures import is_oom_error, release_oom

    cfg, model, dev = profile_model(args, args.quant, weights_only=True)
    frozen_bytes = sum(t.numel() * t.element_size()
                       for t in list(model.parameters()) + list(model.buffers()))
    pcfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, lora_rank=args.rank,
                                                             remat=True))
    lora = make_lora_params(model, rank=args.rank, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    for ab in lora.values():
        ab["b"] = torch.as_tensor(rng.standard_normal(tuple(ab["b"].shape)).astype(np.float32)
                                  * ADAPTER_B_STD)
    insert_lora(model, lora, cfg=pcfg)
    adapters = lora_parameters(model)
    start = {k: p.detach().clone() for k, p in adapters.items()}

    n, r, tc = args.rows, args.prompt_len, args.completion_len
    v = cfg.text.vocab_size
    print(f"frozen model ({args.quant or 'fp'}): {frozen_bytes / 2**30:.2f} GiB; GRPO rows N={n}, "
          f"R={r}, Tc={tc}; one [N, R+Tc, V] fp32 logits buffer would be "
          f"{n * (r + tc) * v * 4 / 2**30:.2f} GiB")
    with torch.no_grad():
        ids = torch.as_tensor(np.array([text_ids(cfg, rng, r + tc) for _ in range(n)]),
                              device=dev)
        pos = torch.arange(r + tc, device=dev).expand(3, n, r + tc)
        batch = GRPOBatch(
            prompt_embeds=model.text.embed(ids[:, :r]),
            prompt_valid=torch.ones((n, r), dtype=torch.bool, device=dev),
            prompt_pos=pos[:, :, :r].contiguous(),
            completion_ids=ids[:, r:].contiguous(),
            completion_valid=torch.ones((n, tc), dtype=torch.bool, device=dev),
            completion_pos=pos[:, :, r:].contiguous(),
            advantages=torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev),
            ref_logps=torch.zeros((n, tc), device=dev))

    def naive_logps(b: GRPOBatch) -> torch.Tensor:
        logits = model.completion_logits(b.prompt_embeds, b.prompt_valid, b.prompt_pos,
                                         b.completion_ids, b.completion_valid,
                                         b.completion_pos)
        return token_logprobs(logits[:, r - 1:-1], b.completion_ids)

    def naive_step_fn(optimizer):
        def step(b: GRPOBatch):
            optimizer.zero_grad()
            logps = naive_logps(b)
            cmask = b.completion_valid.float()
            total = grpo_surrogate(logps, b.advantages, cmask) + KD_WEIGHT * k3_kl(
                logps, b.ref_logps, cmask)
            total.backward()
            optimizer.step()
            return {"grpo_total": total.detach()}

        return step

    def measure(name: str, first, again=None):
        """(a row of ms and peak, or "oom"; first()'s result or None): one
        call of first, then ``--iters`` timed calls of again (default
        first)."""
        again = again or first
        reset_peak(dev)
        try:
            out = first()
            row = {"peak_gib": None, "ms": time_ms(again, dev, args.iters, warmup=0)}
            row["peak_gib"] = peak_gib(dev)
        except Exception as e:
            if not is_oom_error(e):
                raise
            print(f"[{name}] out of memory: {str(e).splitlines()[0][:160]}")
            release_oom(e)
            return "oom", None
        print(f"[{name}] {row['ms']:.1f} ms, peak "
              + ("not measured (CPU)" if row["peak_gib"] is None
                 else f"{row['peak_gib']:.2f} GiB"))
        return row, out

    def restore():
        with torch.no_grad():
            for k, p in adapters.items():
                p.copy_(start[k])

    rows = {}
    rows["ref_fwd_chunked"], ref = measure("ref logps, chunked",
                                           lambda: compute_ref_logps(model, batch))
    if ref is None:
        raise RuntimeError("the chunked reference logprobs ran out of memory: no step can run")
    batch = batch._replace(ref_logps=ref)

    def ref_naive():
        with torch.no_grad(), lora_disabled(model):
            return naive_logps(batch)

    rows["ref_fwd_full_logits"], ref_n = measure("ref logps, full logits", ref_naive)
    losses = {}
    for key, make in (("step_chunked", lambda o: make_grpo_loss_step(model, o, 1.0, KD_WEIGHT)),
                      ("step_full_logits", naive_step_fn)):
        restore()
        step = make(AdamW(adapters, 1e-5))
        rows[key], metrics = measure(f"GRPO step, {key}", lambda: step(batch),
                                     lambda: step(batch))
        if metrics is not None:
            losses[key] = float(metrics["grpo_total"])
    restore()
    rec = {"scale": args.scale, "quant": args.quant, "rows": n, "prompt_len": r,
           "completion_len": tc, "rank": args.rank, "frozen_gb": frozen_bytes / 2**30,
           **rows, "losses": losses}
    if ref_n is not None:
        rec["ref_logps_max_abs_diff"] = float((ref_n.float() - ref.float()).abs().max())
    if len(losses) == 2:
        a, b = losses["step_chunked"], losses["step_full_logits"]
        rec["loss_rel_diff"] = abs(a - b) / max(abs(a), abs(b), 1e-12)
        print(f"losses: chunked {a:.6f}, full logits {b:.6f} (relative difference "
              f"{rec['loss_rel_diff']:.2e})")
    return emit(rec, args.json)


if __name__ == "__main__":
    main()

"""The port's four stage profilers (glimpseprune_torch/tools/profile_*.py)
on the CPU at the tiny config (``--scale tiny --device cpu --json``): each
returns the fields of its JAX counterpart (tools/profile_*.py: the printed
stage times, and the JSON lines of profile_train_step and
profile_grpo_step, XLA's memory_analysis replaced by the peak), with the
shapes JAX's prep gives on the same image; profile_train_step's losses
equal the port's train step on the same batch and weights, and a side that
runs out of memory gives way to the next; profile_grpo_step's chunked and
naive losses agree."""

import argparse
import dataclasses
import warnings

import numpy as np
import pytest

from glimpseprune_tpu.config import tiny_test_config

TINY = ["--scale", "tiny", "--device", "cpu", "--json"]
# JAX's profile_train_step JSON keys but temp_gb / args_gb (XLA's
# memory_analysis), whose place peak_gib takes
JAX_TRAIN_KEYS = {"train_step_s", "train_step_median_s", "n_visual_tokens", "seq", "scale",
                  "quant"}
JAX_GRPO_KEYS = {"scale", "quant", "rows", "prompt_len", "completion_len", "rank", "frozen_gb",
                 "step_chunked", "step_full_logits", "ref_fwd_chunked", "ref_fwd_full_logits"}
# JAX profile_prefill's printed stages: S, n_img, patches, out_len, then
# t_vis, t_enc, t_full, t_fa, t_mm and the breakdown
JAX_PREFILL_KEYS = {"S", "n_img_tokens", "packed_patches", "out_len", "vision_encode_ms",
                    "vision_glimpse_encode_ms", "pruned_prefill_ms", "flash_attention_ms",
                    "matmul_floor_ms", "glimpse_ms", "reduce_resume_ms", "glimpse_layer_ms"}
JAX_DECODE_KEYS = {"contexts", "lm_head_ms", "lm_head_bytes"}


def test_profile_prefill_fields_and_shapes():
    from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner

    from glimpseprune_torch.tools import profile_prefill
    from glimpseprune_torch.tools.common import text_ids

    max_px = 120 * 120
    rec = profile_prefill.main(TINY + ["--max-pixels", str(max_px), "--iters", "1",
                                       "--vision"])
    assert JAX_PREFILL_KEYS <= rec.keys()
    cfg = tiny_test_config()
    side = int((max_px * 1.3) ** 0.5)
    assert rec["image_side"] == side
    rng = np.random.default_rng(0)  # the tool's image and prompt, through JAX's prep
    img = rng.integers(0, 255, (side, side, 3), dtype=np.uint8)
    prompt = (text_ids(cfg, rng, 24) + [cfg.vision_start_token_id, cfg.image_token_id,
                                        cfg.vision_end_token_id] + text_ids(cfg, rng, 24))
    prep = jax_runner.prepare_inputs(cfg, [prompt], [img], max_pixels=max_px)
    assert rec["S"] == prep.input_ids.shape[1]
    assert rec["n_img_tokens"] == int(prep.n_img_tokens[0])
    assert rec["packed_patches"] == prep.patches.shape[0] and rec["out_len"] == prep.out_len
    assert rec["first_logits_finite"] and min(rec["kept_img_tokens"]) >= rec["min_remain_num"]
    assert {"windowed_block_ms", "full_block_ms", "flash_full_ms", "merger_ms",
            "patch_embed_ms"} <= rec["vision_split"].keys()
    assert all(rec[k] > 0 for k in JAX_PREFILL_KEYS if k.endswith("_ms") and
               k not in ("glimpse_ms", "reduce_resume_ms", "glimpse_layer_ms"))


@pytest.mark.parametrize("quant", ["", "int4"])
def test_profile_decode_fields(quant):
    from glimpseprune_torch.tools import profile_decode

    rec = profile_decode.main(TINY + ["--quant", quant, "--contexts", "64", "96", "--iters",
                                      "1"])
    assert JAX_DECODE_KEYS <= rec.keys()
    assert [c["T"] for c in rec["contexts"]] == [64, 96]
    assert all(c["ms_per_step"] > 0 for c in rec["contexts"])
    assert {"slope_ms_per_1k_ctx", "intercept_ms", "implied_bytes_per_1k_ctx"} <= rec.keys()
    assert rec["kv_quant"] == ("int8" if quant else "none")


def test_profile_train_step_loss_and_fallback(monkeypatch):
    """The tool's first loss equals one port train step on the same batch
    from the same weights; with --fallback-sides a side that runs out of
    memory (a CUDA OOM raised in its place here) gives way to the next,
    with a warning, and the record names it."""
    import torch

    from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner

    from glimpseprune_torch.tools import profile_train_step
    from glimpseprune_torch.tools.common import profile_model
    from glimpseprune_torch.training.train_step import AdamW, init_trainable, make_train_step

    argv = TINY + ["--img-side", "96", "--steps", "2", "--quant", "int8"]
    rec = profile_train_step.main(argv)
    assert JAX_TRAIN_KEYS <= rec.keys() and rec["losses_finite"]
    cfg = tiny_test_config()
    img = np.random.default_rng(0).integers(0, 255, (96, 96, 3), dtype=np.uint8)
    prompt = [5, 6, cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id,
              7, 8]
    prep = jax_runner.prepare_inputs(cfg, [prompt], [img], seq_multiple=8, patch_multiple=16,
                                     normed_bboxes=[[[0.2, 0.2, 0.5, 0.5]]],
                                     answer_ids=[[9, 10, 11, 12]], max_pixels=12845056)
    assert rec["n_visual_tokens"] == int(np.sum(prep.input_ids == cfg.image_token_id))
    assert rec["seq"] == prep.input_ids.shape[1]

    args = argparse.Namespace(scale="tiny", device="cpu", seed=0, new_modules=None,
                              hf_model=None, full_params=None, model_config=None)
    pcfg, model, dev = profile_model(
        args, "int8", weights_only=True,
        cfg_edit=lambda c: dataclasses.replace(c, text=dataclasses.replace(c.text, remat=True)))
    trainable = init_trainable(model)
    _, batch = profile_train_step.train_batch(pcfg, 96, 12845056, dev, tiny=True)
    step = make_train_step(pcfg, model, AdamW(trainable, 1e-4))
    loss = float(step(batch, torch.Generator(device=dev).manual_seed(1))["loss"])
    assert loss == rec["losses"][0]

    real = profile_train_step.train_batch

    def oom_at_128(cfg, side, *a, **kw):
        if side == 128:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 9 GiB")
        return real(cfg, side, *a, **kw)

    monkeypatch.setattr(profile_train_step, "train_batch", oom_at_128)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rec = profile_train_step.main(TINY + ["--fallback-sides", "128,96", "--steps", "1",
                                              "--quant", ""])
    assert rec["img_side"] == 96 and rec["oom_sides"] == [128]
    assert rec["ooms"][0]["side"] == 128 and "out of memory" in rec["ooms"][0]["error"]
    assert any("retrying with {'side': 96}" in str(w.message) for w in caught)


def test_profile_grpo_step_losses_agree():
    from glimpseprune_torch.tools import profile_grpo_step

    rec = profile_grpo_step.main(TINY + ["--rows", "2", "--prompt-len", "16",
                                         "--completion-len", "8", "--iters", "1"])
    assert JAX_GRPO_KEYS <= rec.keys()
    for key in ("step_chunked", "step_full_logits", "ref_fwd_chunked", "ref_fwd_full_logits"):
        assert rec[key]["ms"] > 0
    a, b = rec["losses"]["step_chunked"], rec["losses"]["step_full_logits"]
    assert abs(a - b) <= 1e-5 * max(abs(a), abs(b))
    assert rec["ref_logps_max_abs_diff"] < 1e-4

"""The GlimpsePrune knobs the port's runner once refused, against the JAX
runner on shared tiny weights (``params_from_jax``, fp32):

- ``generate(use_ref_masks=True)``: the bbox masks replace the predicted
  ones, the glimpse slots drop out; its keep set is the keep policy applied
  to +-inf logits from ``ref_token_masks``;
- ``gp.use_zero_masks``: -inf logits, so only ``min_remain_num`` per row
  survives;
- ``gp.per_image_policy`` on multi-image rows, and its grouped policy
  against the JAX function on seeded scores;
- ``gp.le_norm_type="layernorm"`` (flax LayerNorm: eps 1e-6, scale and
  bias).

Tolerances: keep sets, tokens and ids identical; logits and mask logits
within 1e-4 of max |JAX| at valid slots."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from glimpseprune_tpu.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
from glimpseprune_tpu.ops import keep_policy as jax_keep
from test_torch_delayed import assert_close
from test_torch_inputs import make_batch_args, make_setup, random_params

BBOXES = [[[0.0, 0.0, 0.5, 1.0]], [[0.5, 0.5, 1.0, 1.0]]]


def multi_image_args(cfg, seed=0):
    """Row 0 holds two images, row 1 one (tests/test_multi_image.py)."""
    rng = np.random.default_rng(seed)
    vs, img, ve = cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id
    prompts = [[7, vs, img, ve, 8, vs, img, ve, 9, 21, 22], [10, vs, img, ve, 11, 23]]
    images = [[rng.integers(0, 255, (64, 96, 3), dtype=np.uint8),
               rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)],
              rng.integers(0, 255, (96, 64, 3), dtype=np.uint8)]
    bboxes = [[[[0.0, 0.0, 0.5, 1.0]], [[0.5, 0.5, 1.0, 1.0]]], [[0.0, 0.0, 1.0, 0.5]]]
    return prompts, images, dict(seq_multiple=8, patch_multiple=16, normed_bboxes=bboxes)


def video_args(cfg, seed=0):
    """Row 0 a video alone, row 1 an image then a video (tests/test_video.py)."""
    rng = np.random.default_rng(seed)
    vs, ve = cfg.vision_start_token_id, cfg.vision_end_token_id
    prompts = [[7, 8, vs, cfg.video_token_id, ve, 9, 31],
               [7, vs, cfg.image_token_id, ve, 11, vs, cfg.video_token_id, ve, 12]]
    images = [None, rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    videos = [rng.integers(0, 255, (4, 64, 96, 3), dtype=np.uint8),
              rng.integers(0, 255, (2, 56, 56, 3), dtype=np.uint8)]
    return prompts, images, dict(seq_multiple=8, patch_multiple=16, videos=videos,
                                 video_seconds_per_grid=[1.0, 1.0])


def preps(cfg, prompts, images, kwargs):
    from glimpseprune_torch.models.qwen2_5_vl import inputs as torch_inputs

    return (jax_runner.prepare_inputs(cfg, prompts, images, **kwargs),
            torch_inputs.prepare_inputs(cfg, prompts, images, **kwargs))


def with_gp(cfg, **gp):
    return dataclasses.replace(cfg, gp=dataclasses.replace(cfg.gp, **gp))


def bound_copy(model, cfg):
    """A copy of the port's model bound to cfg (the same weights)."""
    return copy.deepcopy(model).set_config(cfg)


def assert_same_generate(got, want, check_mask_logits=True, img_valid=None):
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.num_generated, want.num_generated)
    np.testing.assert_array_equal(got.keep_img, np.asarray(want.keep_img))
    np.testing.assert_allclose(got.prune_ratio, want.prune_ratio)
    if check_mask_logits:
        assert_close(got.mask_logits[:, img_valid], np.asarray(want.mask_logits)[:, img_valid])


def host_keep(cfg, prep, logits):
    """The port's keep policy on mask logits [B, N], computed beside the run."""
    import torch

    from glimpseprune_torch.ops.keep_policy import keep_scores_with_policy

    gp = cfg.gp
    return keep_scores_with_policy(torch.sigmoid(torch.as_tensor(logits)),
                                   torch.as_tensor(prep.img_valid), gp.reduce_threshold,
                                   gp.max_remain_ratio, gp.min_remain_num).numpy()


def test_use_ref_masks_generate_matches_jax():
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    prompts, images, kwargs = make_batch_args(s.cfg, 0)
    prep_j, prep_t = preps(s.cfg, prompts, images, dict(kwargs, normed_bboxes=BBOXES))
    want = jax_runner.GlimpsePruneRunner(s.cfg, s.params).generate(
        prep_j, max_new_tokens=6, use_ref_masks=True)
    tr = GlimpsePruneRunner(s.cfg, s.tmodel)
    got = tr.generate(prep_t, max_new_tokens=6, use_ref_masks=True)
    assert_same_generate(got, want, check_mask_logits=False)
    ref = prep_t.ref_token_masks
    np.testing.assert_array_equal(got.mask_logits[0], np.where(ref, np.inf, -np.inf))
    np.testing.assert_array_equal(got.keep_img,
                                  host_keep(s.cfg, prep_t, np.where(ref, np.inf, -np.inf)))
    # the reduction drops the glimpse slots and keeps the text and the kept
    # image tokens
    out = tr.glimpse(prep_t, use_ref_masks=True)
    np.testing.assert_array_equal(
        out.valid.numpy().sum(1), prep_t.valid.sum(1) - s.cfg.gp.le_length
        - prep_t.n_img_tokens + got.keep_img.sum(1))
    with pytest.raises(ValueError, match="bboxes"):
        tr.glimpse(s.prep_t, use_ref_masks=True)


def test_use_zero_masks_keeps_the_floor():
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    cfg = with_gp(s.cfg, use_zero_masks=True)
    want = jax_runner.GlimpsePruneRunner(cfg, s.params).generate(s.prep_j, max_new_tokens=6)
    got = GlimpsePruneRunner(cfg, bound_copy(s.tmodel, cfg)).generate(s.prep_t,
                                                                     max_new_tokens=6)
    assert_same_generate(got, want, check_mask_logits=False)
    assert np.isneginf(got.mask_logits).all()
    np.testing.assert_array_equal(got.keep_img.sum(1),
                                  np.minimum(cfg.gp.min_remain_num, s.prep_t.n_img_tokens))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ratio,floor", [(0.3, 2), (None, 5), (0.5, None)])
def test_grouped_keep_policy_matches_jax(seed, ratio, floor):
    import torch

    from glimpseprune_torch.ops.keep_policy import (
        group_rank_desc,
        keep_scores_with_policy_grouped,
    )

    rng = np.random.default_rng(seed)
    b, n = 3, 40
    probs = rng.random((b, n)).astype(np.float32)
    probs[:, ::7] = probs[:, 1::7]  # ties within a row
    valid = np.ones((b, n), bool)
    valid[1, 30:] = False
    groups = np.stack([np.repeat([0, 1, 2], [10, 20, 10]), np.repeat([0, 1], [15, 25]),
                       np.zeros(n, int)]).astype(np.int32)
    groups[1, 30:] = -1
    anchor = rng.random((b, n)) < 0.05
    want = jax_keep.keep_scores_with_policy_grouped(
        jnp.asarray(probs), jnp.asarray(valid), jnp.asarray(groups), 0.5, ratio, floor,
        jnp.asarray(anchor))
    got = keep_scores_with_policy_grouped(
        torch.as_tensor(probs), torch.as_tensor(valid), torch.as_tensor(groups), 0.5, ratio,
        floor, torch.as_tensor(anchor))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        group_rank_desc(torch.as_tensor(probs), torch.as_tensor(groups),
                        torch.as_tensor(valid)).numpy(),
        np.asarray(jax_keep._group_rank_desc(jnp.asarray(probs), jnp.asarray(groups),
                                             jnp.asarray(valid))))


def test_per_image_policy_generate_matches_jax():
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    cfg = with_gp(s.cfg, per_image_policy=True)
    prep_j, prep_t = preps(cfg, *multi_image_args(cfg))
    assert set(prep_t.img_group[0][prep_t.img_valid[0]].tolist()) == {0, 1}
    want = jax_runner.GlimpsePruneRunner(cfg, s.params).generate(prep_j, max_new_tokens=6)
    got = GlimpsePruneRunner(cfg, bound_copy(s.tmodel, cfg)).generate(prep_t,
                                                                     max_new_tokens=6)
    assert_same_generate(got, want, img_valid=prep_j.img_valid)


def test_layernorm_glimpse_norm_matches_jax():
    import torch

    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.models.layers import LayerNorm
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    cfg = with_gp(s.cfg, le_norm_type="layernorm")
    params = random_params(Qwen2_5_VL_GP(cfg), s.prep_j, seed=2)
    assert set(params["le_norm"]) == {"scale", "bias"}
    model = load_from_jax(params, cfg, device="cpu")
    assert isinstance(model.le_norm, LayerNorm) and model.le_norm.eps == 1e-6
    np.testing.assert_array_equal(model.le_norm.weight.detach().numpy(),
                                  params["le_norm"]["scale"])
    np.testing.assert_array_equal(model.le_norm.bias.detach().numpy(),
                                  params["le_norm"]["bias"])
    jr = jax_runner.GlimpsePruneRunner(cfg, params)
    tr = GlimpsePruneRunner(cfg, model)
    want, got = jr.glimpse(s.prep_j), tr.glimpse(s.prep_t)
    iv = s.prep_j.img_valid
    assert_close(got.mask_logits.numpy()[:, iv], np.asarray(want.mask_logits)[:, iv])
    np.testing.assert_array_equal(got.keep_img.numpy(), np.asarray(want.keep_img))
    assert_close(got.logits.numpy(), np.asarray(want.logits))
    assert_same_generate(tr.generate(s.prep_t, max_new_tokens=6),
                         jr.generate(s.prep_j, max_new_tokens=6), img_valid=iv)
    # the glimpse norm alone, bf16 in, against flax's on the same values
    x = np.random.default_rng(3).standard_normal((2, 5, cfg.text.hidden_size))
    want_n = Qwen2_5_VL_GP(cfg).apply(
        {"params": params}, jnp.asarray(x, jnp.float32),
        method=lambda m, v: m.le_norm(v))
    with torch.no_grad():
        got_n = model.le_norm(torch.as_tensor(x, dtype=torch.float32))
    assert_close(got_n.numpy(), np.asarray(want_n))


def test_runner_accepts_the_eval_knob():
    """``gp.use_ref_masks`` is read by the JAX evalsuite only: the runner
    accepts it and prunes as without it."""
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    cfg = with_gp(s.cfg, use_ref_masks=True)
    got = GlimpsePruneRunner(cfg, bound_copy(s.tmodel, cfg)).glimpse(s.prep_t)
    want = GlimpsePruneRunner(s.cfg, s.tmodel).glimpse(s.prep_t)
    np.testing.assert_array_equal(got.keep_img.numpy(), want.keep_img.numpy())
    np.testing.assert_array_equal(got.logits.numpy(), want.logits.numpy())

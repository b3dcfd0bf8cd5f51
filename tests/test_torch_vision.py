"""The port's ViT (glimpseprune_torch/models/qwen2_5_vl/vision.py) against
the JAX VisionTransformer on the same weights and patches: merged embeds and
taps on every valid merge unit, for a padded two-image pack (window padding,
segmented full attention) and a single unpadded image (the dense path).

Also the importance path of the baseline compressors (``emit_importance``)
on the tiny config, whose importance block is its one full-attention block,
and on a variant whose last block is windowed, so that it runs K8 (window
attention on roped q, k, v), with the JAX side's attention in its Pallas
kernels (interpret mode); and K8's plain version against the Pallas
``window_attention`` in interpret mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from glimpseprune_tpu.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP as JaxModel
from glimpseprune_tpu.ops.pallas.window_attention import window_attention as pallas_window
from test_torch_inputs import make_setup
from test_torch_quant_runner import flash_interpret  # noqa: F401 (fixture)

TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 sums taken in another order


def _single_image_prep(cfg, module):
    rng = np.random.default_rng(5)
    prompt = [7, cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id, 9]
    image = rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)
    return module.prepare_inputs(cfg, [prompt], [image], patch_multiple=16)


@pytest.mark.parametrize("batch", ["two_images", "single_dense"])
def test_vision_encode_matches_jax(batch):
    import torch

    from glimpseprune_torch.models.qwen2_5_vl import inputs as torch_inputs

    s = make_setup()
    if batch == "two_images":
        prep_j, prep_t = s.prep_j, s.prep_t
    else:
        prep_j = _single_image_prep(s.cfg, jax_runner)
        prep_t = _single_image_prep(s.cfg, torch_inputs)
    dense = jax_runner._vis_dense_hint(prep_j)
    assert dense == (batch == "single_dense")
    merged_j, taps_j = s.jmodel.apply(
        {"params": s.params}, jnp.asarray(prep_j.patches), jnp.asarray(prep_j.vis_pos_ids),
        jnp.asarray(prep_j.full_seg), jnp.asarray(prep_j.vis_valid), False, dense,
        method=s.jmodel.vision_encode)
    with torch.inference_mode():
        merged_t, taps_t = s.tmodel.vision_encode(
            torch.as_tensor(prep_t.patches), torch.as_tensor(prep_t.vis_pos_ids),
            torch.as_tensor(prep_t.full_seg), torch.as_tensor(prep_t.vis_valid),
            dense_attn=dense)
    mu = s.cfg.vision.spatial_merge_unit
    unit_valid = prep_j.vis_valid.reshape(-1, mu)[:, 0]
    assert merged_t.shape == merged_j.shape and len(taps_t) == len(taps_j) == 2
    np.testing.assert_allclose(merged_t.numpy()[unit_valid],
                               np.asarray(merged_j)[unit_valid], **TOL)
    for tap_t, tap_j in zip(taps_t, taps_j):
        np.testing.assert_allclose(tap_t.numpy()[unit_valid],
                                   np.asarray(tap_j)[unit_valid], **TOL)


@pytest.mark.parametrize("nw,wp,h,d", [(5, 16, 4, 16), (3, 64, 2, 80)])
def test_window_attention_plain_matches_pallas(nw, wp, h, d):
    """K8's plain version against the Pallas kernel in interpret mode, on
    the valid rows (pad rows attend to themselves on both sides)."""
    import torch

    from glimpseprune_torch.ops.cuda.window_attention import window_attention

    rng = np.random.default_rng(nw)
    p = nw * wp
    q, k, v = (rng.standard_normal((p, h, d)).astype(np.float32) for _ in range(3))
    valid = rng.random(p) > 0.25
    valid[-wp:] = False  # a whole padding window
    want = np.asarray(pallas_window(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(valid), wp, interpret=True))
    got = window_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                           torch.as_tensor(valid), wp)
    assert got.shape == (p, h, d) and window_attention.launches == 0
    np.testing.assert_allclose(got.numpy()[valid], want[valid], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fullatt", [(3,), (1,)])
def test_vision_importance_matches_jax(fullatt, flash_interpret, monkeypatch):
    """(3,): the tiny config, both importance scores from its last block,
    a full-attention one. (1,): local scores from block 1 (full attention),
    global ones from block 3, which is windowed and attends through K8."""
    import copy

    import torch

    from glimpseprune_torch.ops import attention as torch_attention

    k8_calls = []

    def counted(*args):
        k8_calls.append(args[0].shape)
        return window_attention(*args)

    window_attention = torch_attention.window_attention
    monkeypatch.setattr(torch_attention, "window_attention", counted)
    s = make_setup()
    cfg = dataclasses.replace(s.cfg, vision=dataclasses.replace(
        s.cfg.vision, fullatt_block_indexes=fullatt))
    p = s.prep_j
    jm = JaxModel(cfg)
    merged_j, taps_j, imp_j = jm.apply(
        {"params": s.params}, jnp.asarray(p.patches), jnp.asarray(p.vis_pos_ids),
        jnp.asarray(p.full_seg), jnp.asarray(p.vis_valid), True,
        method=jm.vision_encode)
    tmodel = copy.deepcopy(s.tmodel).set_config(cfg)
    with torch.inference_mode():
        merged_t, taps_t, imp_t = tmodel.vision_encode(
            torch.as_tensor(p.patches), torch.as_tensor(p.vis_pos_ids),
            torch.as_tensor(p.full_seg), torch.as_tensor(p.vis_valid), emit_importance=True)
    assert len(k8_calls) == (1 if fullatt == (1,) else 0)
    mu = cfg.vision.spatial_merge_unit
    unit_valid = p.vis_valid.reshape(-1, mu)[:, 0]
    np.testing.assert_allclose(merged_t.numpy()[unit_valid], np.asarray(merged_j)[unit_valid],
                               **TOL)
    for tap_t, tap_j in zip(taps_t, taps_j):
        np.testing.assert_allclose(tap_t.numpy()[unit_valid], np.asarray(tap_j)[unit_valid],
                                   **TOL)
    received, keys_mean, received_local = (x.numpy() for x in imp_t)
    assert received.shape == (unit_valid.size,) and keys_mean.shape == (
        unit_valid.size, cfg.vision.head_dim)
    for got, want in zip((received, keys_mean, received_local), imp_j):
        np.testing.assert_allclose(got[unit_valid], np.asarray(want)[unit_valid], **TOL)
    # the two scores come from different blocks exactly when those differ
    assert np.array_equal(received, received_local) == (fullatt == (3,))

"""The port's ViT (glimpseprune_torch/models/qwen2_5_vl/vision.py) against
the JAX VisionTransformer on the same weights and patches: merged embeds and
taps on every valid merge unit, for a padded two-image pack (window padding,
segmented full attention) and a single unpadded image (the dense path)."""

import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from test_torch_inputs import make_setup

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

"""The port's pruned prefill (glimpseprune_torch/models/qwen2_5_vl/gp_model.py
through the runner's ``glimpse``) against the JAX runner's on the same
weights and inputs: mask logits, then exactly the same keep set, compacted
ids, positions and valid mask, then the compacted KV and the first logits;
and the unpruned comparator's prefill."""

import jax.numpy as jnp
import numpy as np

from glimpseprune_tpu.models.qwen2_5_vl.runner import GlimpsePruneRunner as JaxRunner
from test_torch_inputs import make_setup

TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 sums taken in another order


def test_glimpse_prefill_matches_jax():
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    want = JaxRunner(s.cfg, s.params).glimpse(s.prep_j)
    got = GlimpsePruneRunner(s.cfg, s.tmodel).glimpse(s.prep_t)
    img_valid = s.prep_j.img_valid
    np.testing.assert_allclose(got.mask_logits.numpy()[:, img_valid],
                               np.asarray(want.mask_logits)[:, img_valid], **TOL)
    keep = got.keep_img.numpy()
    np.testing.assert_array_equal(keep, np.asarray(want.keep_img))
    assert 0 < keep.sum() < img_valid.sum()  # the policy really pruned
    np.testing.assert_array_equal(got.input_ids.numpy(), np.asarray(want.input_ids))
    np.testing.assert_array_equal(got.position_ids.numpy(), np.asarray(want.position_ids))
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    assert got.kv_k.shape == want.kv_k.shape
    np.testing.assert_allclose(got.kv_k.numpy()[:, valid], np.asarray(want.kv_k)[:, valid],
                               **TOL)
    np.testing.assert_allclose(got.kv_v.numpy()[:, valid], np.asarray(want.kv_v)[:, valid],
                               **TOL)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **TOL)


def test_vanilla_prefill_matches_jax():
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    p = s.prep_j
    jm = s.jmodel
    merged, _ = jm.apply({"params": s.params}, jnp.asarray(p.patches),
                         jnp.asarray(p.vis_pos_ids), jnp.asarray(p.full_seg),
                         jnp.asarray(p.vis_valid), method=jm.vision_encode)
    le = s.cfg.gp.le_length
    logits_j, k_j, _ = jm.apply(
        {"params": s.params}, jnp.asarray(p.input_ids[:, :-le]), jnp.asarray(p.valid[:, :-le]),
        jnp.asarray(p.position_ids[:, :, :-le]), merged, jnp.asarray(p.packed_idx),
        jnp.asarray(p.img_slots), jnp.asarray(p.img_valid), method=jm.vanilla_prefill)
    pre = GlimpsePruneRunner(s.cfg, s.tmodel).prefill(s.prep_t, do_selection=False)
    valid = pre.valid.numpy()
    np.testing.assert_array_equal(valid, p.valid[:, :-le])
    np.testing.assert_allclose(pre.logits.numpy(), np.asarray(logits_j)[:, -1:], **TOL)
    np.testing.assert_allclose(pre.kv_k.numpy()[:, valid], np.asarray(k_j)[:, valid], **TOL)
    assert pre.keep_img is None and isinstance(pre.kv_v, torch.Tensor)

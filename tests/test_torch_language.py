"""The port's text decoder (glimpseprune_torch/models/qwen2_5_vl/language.py)
against the JAX TextDecoder on the same weights: ``run_layers`` hidden
states, KV and harvested glimpse rows, with the glimpse embeddings injected
(the glimpse encode) and without (the layers after the reduction), and the
final norm + LM head."""

import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.ops.rope import mrope_cos_sin as jax_mrope
from test_torch_inputs import make_setup

TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 sums taken in another order


@pytest.mark.parametrize("phase", ["glimpse_encode", "after_reduction"])
def test_run_layers_matches_jax(phase):
    import torch

    s = make_setup()
    cfg, prep = s.cfg, s.prep_j
    t, gp = cfg.text, cfg.gp
    b, sl = prep.input_ids.shape
    rng = np.random.default_rng(1)
    embeds = rng.standard_normal((b, sl, t.hidden_size)).astype(np.float32)
    valid, pos, le_start = prep.valid, prep.position_ids, prep.le_start
    if phase == "glimpse_encode":
        start, end, harvest = 0, gp.reduce_layer, tuple(gp.selected_layers)
    else:
        start, end, harvest = gp.reduce_layer + 1, t.num_hidden_layers - 1, ()

    def run_jax(m):
        cos, sin = jax_mrope(jnp.asarray(pos), t.head_dim, t.rope_theta, t.mrope_section)
        kw = {}
        if phase == "glimpse_encode":
            off, inside = m._le_geometry(jnp.asarray(le_start), sl, gp.le_length)
            kw = dict(le_vecs=m._le_vectors_all(False), le_offset=off, le_inside=inside,
                      q_index=jnp.asarray(le_start) + gp.le_length - 1)
        return m.text.run_layers(jnp.asarray(embeds), cos, sin, jnp.asarray(valid),
                                 layer_start=start, layer_end=end, harvest_layers=harvest,
                                 **kw)

    x_j, (k_j, v_j), h_j = s.jmodel.apply({"params": s.params}, method=run_jax)
    m = s.tmodel
    with torch.inference_mode():
        cos, sin = m._cos_sin(torch.as_tensor(pos))
        kw = {}
        if phase == "glimpse_encode":
            ls = torch.as_tensor(le_start)
            off, inside = m._le_geometry(ls, sl, gp.le_length)
            kw = dict(le_vecs=m._le_vectors_all(), le_offset=off, le_inside=inside,
                      q_index=ls + gp.le_length - 1)
        x_t, (k_t, v_t), h_t = m.text.run_layers(
            torch.as_tensor(embeds), cos, sin, torch.as_tensor(valid), layer_start=start,
            layer_end=end, harvest_layers=harvest, **kw)
        logits_t = m.text.logits(m.text.final_norm(x_t))
    logits_j = s.jmodel.apply({"params": s.params}, x_j,
                              method=lambda mm, x: mm.text.logits(mm.text.final_norm(x)))
    # padding rows differ by design (the kernel's zero rows); compare valid rows
    np.testing.assert_allclose(x_t.numpy()[valid], np.asarray(x_j)[valid], **TOL)
    np.testing.assert_allclose(logits_t.numpy()[valid], np.asarray(logits_j)[valid], **TOL)
    assert k_t.shape == k_j.shape == (end - start + 1, b, sl, t.num_key_value_heads, t.head_dim)
    np.testing.assert_allclose(k_t.numpy()[:, valid], np.asarray(k_j)[:, valid], **TOL)
    np.testing.assert_allclose(v_t.numpy()[:, valid], np.asarray(v_j)[:, valid], **TOL)
    assert sorted(h_t) == sorted(h_j) == sorted(harvest)
    for lid in harvest:
        row_t, row_j = h_t[lid].numpy(), np.asarray(h_j[lid])
        assert row_t.shape == (b, sl, t.num_attention_heads)
        np.testing.assert_array_equal(np.isinf(row_t), np.isinf(row_j))
        np.testing.assert_allclose(row_t[valid], row_j[valid], **TOL)

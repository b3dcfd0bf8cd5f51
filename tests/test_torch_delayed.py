"""The port's delayed selection, visualization harvest and teacher-forcing
logits against the JAX runner on the shared tiny setup (fp32 weights from
``params_from_jax``, the same prep):

- ``glimpse_delayed`` then ``apply_selection`` equal to the JAX pair and to
  the port's one-shot ``glimpse``; overridden logits (+inf on a chosen set,
  -inf elsewhere) keep exactly that set, as in JAX;
- ``harvest_rows`` in both modes (the glimpse query's log-prob rows, and
  the multi-query softmax rows from q_start on);
- ``text_prefill_logits``.

Tolerances: keep sets and ids identical; logits, mask logits, rows and
states within 1e-4 of max |JAX| (fp32 sums taken in another order), at
valid slots only (pad rows differ by design, ROADMAP queue 3)."""

import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.models.qwen2_5_vl.runner import GlimpsePruneRunner as JaxRunner
from test_torch_inputs import make_setup

RTOL = 1e-4


def assert_close(got, want, mask=None, rtol=RTOL):
    """max |got - want| <= rtol * max |want| (over mask's True entries)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max err {err:.3e} > {rtol} x {scale:.3e}"


def runners():
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    return s, JaxRunner(s.cfg, s.params), GlimpsePruneRunner(s.cfg, s.tmodel)


def test_delayed_selection_matches_jax_and_one_shot():
    s, jr, tr = runners()
    iv = s.prep_j.img_valid
    ml_j, st_j = jr.glimpse_delayed(s.prep_j)
    ml_t, st_t = tr.glimpse_delayed(s.prep_t)
    assert_close(ml_t.numpy()[:, iv], np.asarray(ml_j)[:, iv])
    valid = np.asarray(st_j.valid)
    np.testing.assert_array_equal(st_t.valid.numpy(), valid)
    np.testing.assert_array_equal(st_t.keep_base.numpy(), np.asarray(st_j.keep_base))
    np.testing.assert_array_equal(st_t.img_group.numpy(), np.asarray(st_j.img_group))
    assert_close(st_t.embeds.numpy(), np.asarray(st_j.embeds), valid)
    assert_close(st_t.hidden.numpy(), np.asarray(st_j.hidden), valid)

    out_j = jr.apply_selection(st_j, ml_j, s.prep_j.out_len)
    out_t = tr.apply_selection(st_t, ml_t, s.prep_t.out_len)
    one = tr.glimpse(s.prep_t)
    keep = out_t.keep_img.numpy()
    np.testing.assert_array_equal(keep, np.asarray(out_j.keep_img))
    np.testing.assert_array_equal(keep, one.keep_img.numpy())
    assert 0 < keep.sum() < iv.sum()
    np.testing.assert_array_equal(out_t.input_ids.numpy(), np.asarray(out_j.input_ids))
    r_valid = out_t.valid.numpy()
    assert_close(out_t.embeds.numpy(), np.asarray(out_j.embeds), r_valid)
    assert_close(out_t.logits.numpy(), np.asarray(out_j.logits))
    np.testing.assert_array_equal(out_t.logits.numpy(), one.logits.numpy())


def test_apply_selection_override_keeps_the_chosen_set():
    """+inf on two image tokens of each row, -inf elsewhere: the keep set is
    exactly those two (min_remain_num is at most 2 on the tiny config)."""
    import torch

    s, jr, tr = runners()
    ml_j, st_j = jr.glimpse_delayed(s.prep_j)
    ml_t, st_t = tr.glimpse_delayed(s.prep_t)
    chosen = np.zeros(s.prep_j.img_valid.shape, bool)
    for b in range(chosen.shape[0]):
        idx = np.nonzero(s.prep_j.img_valid[b])[0]
        chosen[b, idx[[0, -1]]] = True
    over = np.where(chosen, np.inf, -np.inf)[None].astype(np.float32)
    assert s.cfg.gp.min_remain_num <= 2
    out_j = jr.apply_selection(st_j, jnp.asarray(over), s.prep_j.out_len)
    out_t = tr.apply_selection(st_t, torch.as_tensor(over), s.prep_t.out_len)
    np.testing.assert_array_equal(out_t.keep_img.numpy(), chosen)
    np.testing.assert_array_equal(out_t.keep_img.numpy(), np.asarray(out_j.keep_img))
    assert_close(out_t.logits.numpy(), np.asarray(out_j.logits))


@pytest.mark.parametrize("q_back", [None, 3])
def test_harvest_rows_matches_jax(q_back):
    s, jr, tr = runners()
    layers = (0, 1)
    q_start = None if q_back is None else s.prep_j.input_ids.shape[1] - q_back
    want = jr.harvest_rows(s.prep_j, layers=layers, q_start=q_start)
    got = tr.harvest_rows(s.prep_t, layers=layers, q_start=q_start)
    assert set(got) == set(want) == set(layers)
    iv = s.prep_j.img_valid
    for l in layers:
        g, w = got[l].numpy(), np.asarray(want[l])
        if q_start is None:
            assert g.shape == (2, iv.shape[1], s.cfg.text.num_attention_heads)
            assert_close(g, w, iv)
        else:
            assert g.shape == (2, q_back, iv.shape[1], s.cfg.text.num_attention_heads)
            assert ((g >= 0) & (g <= 1)).all()
            assert_close(g.transpose(0, 2, 1, 3), w.transpose(0, 2, 1, 3), iv)


def test_text_prefill_logits_matches_jax():
    import torch

    s = make_setup()
    p = s.prep_j
    jm = s.jmodel
    want = jm.apply({"params": s.params}, jnp.asarray(p.input_ids), jnp.asarray(p.valid),
                    jnp.asarray(p.position_ids), method=jm.text_prefill_logits)
    with torch.inference_mode():
        got = s.tmodel.text_prefill_logits(torch.as_tensor(p.input_ids),
                                           torch.as_tensor(p.valid),
                                           torch.as_tensor(p.position_ids))
    assert_close(got.numpy(), np.asarray(want), p.valid)

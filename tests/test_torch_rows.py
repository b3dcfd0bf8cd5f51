"""Multi-image and video rows through paths the port already runs, against
the JAX runner on the shared tiny weights: row 0 of the multi-image batch
holds two images and row 1 one; row 0 of the video batch holds a video
alone and row 1 an image then a video.

- (q8) and (q4) ``generate``, pruned and unpruned, with the JAX attention in
  its Pallas kernels (interpret mode) as in test_torch_quant_runner.py;
- ``generate_compressed`` with each of the five compressors
  (test_torch_rows_compressed.py).

Tolerances: greedy tokens, counts, keep sets and prune ratios identical,
but for the (q8) pruned prefill. W8A8 rounds every activation row to int8,
and on these rows fp32 differences of ~1e-6 upstream (the vision tower's,
such as the 1176-wide patch embedding summed in another order, and the
text layers' attention sums) move some values across a rounding boundary,
one int8 step each: the mask logits then move by 1.0-1.2% of the largest
and the first logits by 1.5-1.7% (measured on these rows; the shared batch
of test_torch_quant_runner.py happens to cross none). So there the mask
and first logits are held within INT8_FLIP_RTOL of the largest, a keep
slot may differ only where JAX's logit is within that band of the
threshold or of the ratio cap's cut, the JAX runner then prunes to the
port's keep set, and the greedy tokens must agree up to a step whose port
logits put the JAX token within the band of their top.

That bound does not catch a fault in the W8A8 product itself: two planted
ones (one activation scale for the whole tensor; truncation in place of
rounding) read 1.7-3.4% there. Two more tests pin the cause instead. With
the JAX vision tower's outputs fed to the port, keep sets, prune ratios and
greedy tokens on these rows are identical to JAX's. And every W8A8 product
of the port's run on these rows equals JAX's ``matmul_w8a8`` on the same
activations within W8A8_RTOL (1 ulp measured; the planted faults read
4.1-6.8e-2 of the largest output there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from test_torch_delayed import assert_close
from test_torch_gp_knobs import multi_image_args, preps, video_args
from test_torch_quant_runner import _tier
from test_torch_quant_runner import flash_interpret  # noqa: F401 (fixture)

ROWS = {"multi_image": multi_image_args, "video": video_args}
INT8_FLIP_RTOL = 0.1
W8A8_RTOL = 1e-6
N_NEW = 8


def assert_same(got, want):
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.num_generated, want.num_generated)
    if want.keep_img is None:
        assert got.keep_img is None
    else:
        np.testing.assert_array_equal(got.keep_img, np.asarray(want.keep_img))
    if want.prune_ratio is not None:
        np.testing.assert_allclose(got.prune_ratio, want.prune_ratio, rtol=0, atol=1e-12)


@pytest.mark.parametrize("do_selection", [True, False])
@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("tier", ["q8", "q4"])
def test_quantized_generate_on_rows_matches_jax(tier, rows, do_selection, flash_interpret):
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s, jcfg, qparams, tcfg, tmodel = _tier(tier)
    prep_j, prep_t = preps(s.cfg, *ROWS[rows](s.cfg))
    jr = jax_runner.GlimpsePruneRunner(jcfg, qparams)
    tr = GlimpsePruneRunner(tcfg, tmodel)
    if tier == "q8" and do_selection:
        return assert_int8_flips_only(jr, tr, prep_j, prep_t)
    want = jr.generate(prep_j, max_new_tokens=N_NEW, do_selection=do_selection)
    got = tr.generate(prep_t, max_new_tokens=N_NEW, do_selection=do_selection)
    assert_same(got, want)


def assert_int8_flips_only(jr, tr, prep_j, prep_t):
    """The (q8) pruned path held within W8A8's rounding flips (above)."""
    ml_j, st_j = jr.glimpse_delayed(prep_j)
    ml_t, st_t = tr.glimpse_delayed(prep_t)
    iv = prep_j.img_valid
    ml_j, ml_tn = np.asarray(ml_j), ml_t.numpy()
    assert_close(ml_tn[:, iv], ml_j[:, iv], rtol=INT8_FLIP_RTOL)
    out_t = tr.apply_selection(st_t, ml_t, prep_t.out_len)
    keep = out_t.keep_img.numpy()
    keep_j = np.asarray(jr.apply_selection(st_j, jnp.asarray(ml_j), prep_j.out_len).keep_img)
    thr = jr.cfg.gp.reduce_threshold
    band = INT8_FLIP_RTOL * np.abs(ml_j[-1][iv]).max()
    for b in np.nonzero((keep != keep_j).any(1))[0]:
        # a slot may change sides only near the threshold or near the
        # ratio cap's cut (the last kept logit of JAX's set)
        lj = ml_j[-1][b]
        cuts = np.array([np.log(thr / (1 - thr)), lj[keep_j[b]].min()])
        near = np.abs(lj[keep[b] != keep_j[b]][:, None] - cuts).min(1)
        assert (near <= band).all(), (b, near, band)
    over = np.where(keep, np.inf, -np.inf)[None].astype(np.float32)
    out_j = jr.apply_selection(st_j, jnp.asarray(over), prep_j.out_len)
    np.testing.assert_array_equal(np.asarray(out_j.keep_img), keep)
    assert_close(out_t.logits.numpy(), np.asarray(out_j.logits), rtol=INT8_FLIP_RTOL)
    want, _ = jr._decode_loop(out_j.logits, out_j.valid, out_j.position_ids, out_j.kv_k,
                              out_j.kv_v, N_NEW, -1)
    steps = tr.decode_steps(out_t.logits, out_t.valid, out_t.position_ids, out_t.kv_k,
                            out_t.kv_v, out_t.valid.shape[1] + N_NEW, -1)
    logits = [out_t.logits[:, -1].numpy()]
    for _ in range(N_NEW - 1):
        steps.run(1)
        logits.append(steps.logits.numpy())
    steps.run(1)
    got = steps.state.toks[:, :N_NEW].numpy()
    for b in range(got.shape[0]):
        diff = np.nonzero(got[b] != np.asarray(want)[b, :N_NEW])[0]
        if len(diff):  # a tie within the band; the contexts part from there
            lg = logits[diff[0]][b]
            assert lg[np.asarray(want)[b, diff[0]]] >= lg.max() - INT8_FLIP_RTOL * np.abs(lg).max()


@pytest.mark.parametrize("rows", sorted(ROWS))
def test_q8_pruned_rows_match_jax_on_jax_vision(rows, flash_interpret, monkeypatch):
    """The (q8) pruned path on these rows with the port's vision tower
    replaced by the JAX one's outputs: keep sets, prune ratios and greedy
    tokens identical to JAX's. The mask logits still move by up to 1.2% of
    the largest (measured), from flips in the text layers' W8A8 rounding,
    so they are held within INT8_FLIP_RTOL."""
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s, jcfg, qparams, tcfg, tmodel = _tier("q8")
    prep_j, prep_t = preps(s.cfg, *ROWS[rows](s.cfg))
    jr = jax_runner.GlimpsePruneRunner(jcfg, qparams)
    tr = GlimpsePruneRunner(tcfg, tmodel)

    def jax_vision(patches, pos_ids, full_seg, vis_valid, dense_attn=False,
                   emit_importance=False):
        assert not emit_importance
        args = [jnp.asarray(x.numpy()) for x in (patches, pos_ids, full_seg, vis_valid)]
        merged, taps = jr.model.apply({"params": jr.params}, *args,
                                      method=jr.model.vision_encode)
        as_t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32)).to(tmodel.dtype)
        return as_t(merged), [as_t(x) for x in taps]

    monkeypatch.setattr(tmodel, "vision_encode", jax_vision)
    ml_j, _ = jr.glimpse_delayed(prep_j)
    ml_t, _ = tr.glimpse_delayed(prep_t)
    iv = prep_j.img_valid
    assert_close(ml_t.numpy()[:, iv], np.asarray(ml_j)[:, iv], rtol=INT8_FLIP_RTOL)
    want = jr.generate(prep_j, max_new_tokens=N_NEW)
    got = tr.generate(prep_t, max_new_tokens=N_NEW)
    assert_same(got, want)


@pytest.mark.parametrize("rows", sorted(ROWS))
def test_q8_w8a8_products_on_rows_match_jax(rows, monkeypatch):
    """Every W8A8 product of the port's (q8) pruned generate on these rows,
    fed to JAX's ``matmul_w8a8`` on the same activations and weights: within
    W8A8_RTOL of the largest output (measured: 1 ulp, from the rescale's
    fp32 products; one activation rounded one step the other way moves an
    output by ~1e-3 of the largest). So the port rounds these rows' own
    activations as JAX does, and what the other tests of this file allow is
    the fp32 difference upstream of the rounding."""
    import jax
    from glimpseprune_tpu import quantization as jq
    from glimpseprune_torch.models import layers
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s, _, _, tcfg, tmodel = _tier("q8")
    _, prep_t = preps(s.cfg, *ROWS[rows](s.cfg))
    calls, own = [], layers.matmul_w8a8

    def record(x, kernel_q, kernel_scale, dtype):
        y = own(x, kernel_q, kernel_scale, dtype)
        calls.append((x.numpy().copy(), kernel_q.numpy().copy(),
                      kernel_scale.numpy().copy(), y.numpy().copy()))
        return y

    monkeypatch.setattr(layers, "matmul_w8a8", record)
    GlimpsePruneRunner(tcfg, tmodel).generate(prep_t, max_new_tokens=N_NEW)
    assert len(calls) >= 7 * tcfg.text.num_hidden_layers
    ref = jax.jit(jq.matmul_w8a8, static_argnums=3)
    for x, kq, ks, y in calls:
        assert_close(y, np.asarray(ref(x, kq, ks, jnp.float32)), rtol=W8A8_RTOL)

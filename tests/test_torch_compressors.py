"""The port's baseline compressors (glimpseprune_torch/compressors/,
``Qwen2_5_VL_GP.staged_prefill`` and the runner's ``generate_compressed``)
against the JAX package on the same inputs and weights:

- each selector against its JAX function on shared seeded inputs, with
  padded rows: keep masks equal, merged embeddings within 1e-5 (fp32 sums
  taken in another order);
- the staged in-LLM drop (PyramidDrop): logits, ids, valid mask,
  positions, KV and the image mask after the last stage;
- ``generate_compressed``: greedy tokens, ``keep_img`` and ``prune_ratio``
  equal to the JAX runner's for all five methods, with the kwargs of
  tests/test_compressors.py's end-to-end test;
- one (q4) case with int8 ViT attention (visionzip), whose importance block
  must run bf16 attention as the JAX package's does.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu import compressors as jc
from glimpseprune_tpu.compressors import vscan as jvscan
from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from test_torch_inputs import make_setup
from test_torch_quant_runner import LOGIT_RTOL, _tier
from test_torch_quant_runner import flash_interpret  # noqa: F401 (fixture)

TOL = dict(atol=1e-5, rtol=1e-5)  # fp32 sums taken in another order
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)  # through the tiny model, as the other parity tests
METHODS = ("visionzip", "divprune", "cdpruner", "vscan", "pdrop")
# tests/test_compressors.py::test_compressed_generate_runs
STAGES = ((1, 0.5), (2, 0.25))


def method_kwargs(method):
    kwargs = dict(max_new_tokens=4)
    if method in ("divprune", "cdpruner", "vscan"):
        kwargs["visual_token_num"] = 2  # rows have 6 and 4 image tokens
    if method == "pdrop":
        kwargs["stages"] = STAGES
    return kwargs


def selector_inputs(seed):
    """Two rows of 40 slots, the second with a padded tail of 10, and a
    raster grid per row (5 x 8 and 6 x 5) for VScan's windows."""
    rng = np.random.default_rng(seed)
    b, n = 2, 40
    valid = np.ones((b, n), bool)
    valid[1, 30:] = False
    return dict(
        embeds=rng.standard_normal((b, n, 8)).astype(np.float32),
        scores=rng.random((b, n)).astype(np.float32),
        scores2=rng.random((b, n)).astype(np.float32),
        keys=rng.standard_normal((b, n, 4)).astype(np.float32),
        valid=valid,
        grid_hw=np.array([[5, 8], [6, 5]], np.int64),
    )


def run_selector(which, x, lib, as_array):
    """(keep, merged embeds or None) of one selector from a package."""
    a = {k: as_array(v) for k, v in x.items()}
    if which == "visionzip":
        return lib["visionzip"](a["embeds"], a["scores"], a["keys"], a["valid"], 0.5, 0.1)
    if which == "divprune":
        return lib["divprune"](a["embeds"], a["valid"], 6), None
    if which == "cdpruner":
        return lib["cdpruner"](a["embeds"], a["scores"], a["valid"], 7), None
    keep = lib["vscan"](a["scores"], a["scores2"], a["valid"], a["grid_hw"], 12, window=2)
    if which == "vscan":
        return keep, None
    return keep, lib["merge"](a["embeds"], keep, a["valid"])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("which", ["visionzip", "divprune", "cdpruner", "vscan", "vscan_merge"])
def test_selector_matches_jax(which, seed):
    import torch

    from glimpseprune_torch import compressors as tc
    from glimpseprune_torch.compressors import vscan as tvscan

    x = selector_inputs(seed)
    jlib = dict(visionzip=jc.visionzip_select, divprune=jc.divprune_select,
                cdpruner=jc.cdpruner_select, vscan=jvscan.vscan_select,
                merge=jvscan.merge_dropped_into_kept)
    tlib = dict(visionzip=tc.visionzip_select, divprune=tc.divprune_select,
                cdpruner=tc.cdpruner_select, vscan=tvscan.vscan_select,
                merge=tvscan.merge_dropped_into_kept)
    keep_j, emb_j = run_selector(which, x, jlib, jnp.asarray)
    keep_t, emb_t = run_selector(which, x, tlib, torch.as_tensor)
    keep_j = np.asarray(keep_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    assert 0 < keep_j[1].sum() < x["valid"][1].sum() and not (keep_j & ~x["valid"]).any()
    if emb_j is not None:
        np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), **TOL)
        assert not np.allclose(np.asarray(emb_j), x["embeds"])  # the merge moved something


def test_staged_schedule_matches_jax():
    from glimpseprune_torch.compressors import StagedDropConfig, staged_drop_schedule

    stages = ((8, 0.5), (16, 0.25), (24, 0.125))
    for n_img, s, r in ((768, 832, 64), (6, 27, 8)):
        assert staged_drop_schedule(n_img, s, stages, r) == \
            jc.staged_drop_schedule(n_img, s, stages, r)
    assert StagedDropConfig().validate(28).stages == jc.StagedDropConfig().validate(28).stages
    for bad in (((8, 0.5), (8, 0.25)), ((8, 0.25), (16, 0.5)), ((28, 0.5),)):
        with pytest.raises(ValueError):
            StagedDropConfig(bad).validate(28)


def test_staged_prefill_matches_jax():
    import torch

    s = make_setup()
    p, jm = s.prep_j, s.jmodel
    le = s.cfg.gp.le_length
    ids, valid, pos = p.input_ids[:, :-le], p.valid[:, :-le], p.position_ids[:, :, :-le]
    out_lens = tuple(jc.staged_drop_schedule(int(p.n_img_tokens.max()), ids.shape[1], STAGES,
                                             round_to=8))
    merged, _ = jm.apply({"params": s.params}, jnp.asarray(p.patches),
                         jnp.asarray(p.vis_pos_ids), jnp.asarray(p.full_seg),
                         jnp.asarray(p.vis_valid), method=jm.vision_encode)
    want = jm.apply({"params": s.params}, method=lambda m: m.staged_prefill(
        jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(pos), merged,
        jnp.asarray(p.packed_idx), jnp.asarray(p.img_slots), jnp.asarray(p.img_valid),
        STAGES, out_lens))
    t = {k: torch.as_tensor(v) for k, v in dict(
        ids=ids, valid=valid, pos=pos, packed_idx=p.packed_idx, img_slots=p.img_slots,
        img_valid=p.img_valid).items()}
    with torch.inference_mode():
        merged_t, _ = s.tmodel.vision_encode(
            torch.as_tensor(p.patches), torch.as_tensor(p.vis_pos_ids),
            torch.as_tensor(p.full_seg), torch.as_tensor(p.vis_valid))
        got = s.tmodel.staged_prefill(t["ids"], t["valid"], t["pos"], merged_t,
                                      t["packed_idx"], t["img_slots"], t["img_valid"], STAGES,
                                      out_lens)
    logits, r_ids, r_valid, r_pos, kv_k, kv_v, is_img = (np.asarray(w) for w in want)
    v = got[2].numpy()
    np.testing.assert_array_equal(v, r_valid)
    for g, w in ((got[1], r_ids), (got[3], r_pos), (got[6], is_img)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert is_img.sum(1).tolist() == [max(int(0.25 * n), 1) for n in p.n_img_tokens]
    assert got[4].shape == kv_k.shape == (s.cfg.text.num_hidden_layers,) + v.shape + \
        kv_k.shape[3:]
    np.testing.assert_allclose(got[4].numpy()[:, v], kv_k[:, v], **MODEL_TOL)
    np.testing.assert_allclose(got[5].numpy()[:, v], kv_v[:, v], **MODEL_TOL)
    np.testing.assert_allclose(got[0].numpy(), logits, **MODEL_TOL)


@pytest.mark.parametrize("method", METHODS)
def test_generate_compressed_matches_jax(method):
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    kwargs = method_kwargs(method)
    want = jax_runner.GlimpsePruneRunner(s.cfg, s.params).generate_compressed(
        s.prep_j, method, **kwargs)
    got = GlimpsePruneRunner(s.cfg, s.tmodel).generate_compressed(s.prep_t, method, **kwargs)
    assert got.sequences.shape == (2, 4)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.num_generated, want.num_generated)
    np.testing.assert_array_equal(got.prune_ratio, want.prune_ratio)
    assert ((got.prune_ratio > 0) & (got.prune_ratio < 1)).all()
    if method == "pdrop":
        assert got.keep_img is None and want.keep_img is None
    else:
        np.testing.assert_array_equal(got.keep_img, want.keep_img)
    if method in ("divprune", "cdpruner", "vscan"):
        np.testing.assert_array_equal(got.keep_img.sum(1), [2, 2])


def test_q4_visionzip_importance_runs_bf16_attention(flash_interpret):
    """(q4) with int8 ViT attention: the full-attention importance block of
    the tiny config (block 3, the last) runs bf16 attention on both sides,
    so the compressed prefill's first logits agree as closely as the int8
    tiers' prefills do (test_torch_quant_runner: ~1e-5 of the largest; the
    int8 tier in that block would move them by ~7e-4)."""
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s, jcfg, qparams, tcfg, tmodel = _tier("q4")
    assert jcfg.vision.attn_qk_int8 and tcfg.vision.attn_qk_int8
    jr = jax_runner.GlimpsePruneRunner(jcfg, qparams)
    tr = GlimpsePruneRunner(tcfg, tmodel)
    want = jr.generate_compressed(s.prep_j, "visionzip", max_new_tokens=4)
    got = tr.generate_compressed(s.prep_t, "visionzip", max_new_tokens=4)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.keep_img, want.keep_img)

    # the JAX runner's compressed prefill, as its generate_compressed calls it
    p = s.prep_j
    inputs = jr._device_inputs(p, False)
    le = jcfg.gp.le_length
    for key in ("input_ids", "valid"):
        inputs[key] = inputs[key][:, :-le]
    inputs["position_ids"] = inputs["position_ids"][:, :, :-le]
    n, s_len = p.img_valid.shape[1], inputs["input_ids"].shape[1]
    k = int(0.7 * n) + 2
    out_len = min(jax_runner._round_up(s_len - int(p.n_img_tokens.min()) + min(k, n), 8),
                  s_len)
    logits_j = np.asarray(jr._pre_llm_compress({"params": qparams}, inputs, "visionzip", k,
                                               out_len, 0.65, 0.05)[0])
    logits_t = tr.prefill_compressed(s.prep_t, "visionzip").logits.numpy()
    err = np.abs(logits_t - logits_j).max() / np.abs(logits_j).max()
    assert err <= LOGIT_RTOL, err


def test_generate_compressed_refusals():
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    runner = GlimpsePruneRunner(s.cfg, s.tmodel)
    with pytest.raises(ValueError, match="LLaVA"):
        runner.generate_compressed(s.prep_t, "cdpruner", clip_text_ids=np.zeros((1, 77)))
    with pytest.raises(ValueError, match="unknown compressor"):
        runner.generate_compressed(s.prep_t, "tome")

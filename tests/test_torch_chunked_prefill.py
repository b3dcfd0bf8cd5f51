"""The port's chunked prefill (glimpseprune_torch: ``decode_attention``'s
``new_valid`` and legacy modes, ``TextDecoder.decode_step`` with
``inputs_embeds`` / ``logits_index`` / ``new_valid``,
``Qwen2_5_VL_GP.embed_with_images`` without images and ``prefill_chunk``,
the runner's ``vanilla_prefill_chunked`` / ``vanilla_prefill_chunked_steps``)
against the JAX package's on the same tiny weights and inputs, fp32 on the
CPU; and the port of tests/test_chunked_prefill.py: the chunked prefill
gives the monolithic unpruned prefill's logits and greedy tokens.

Attention outputs are compared on the rows of real queries: a query at a
pad slot has no allowed key, and its row is the uniform average over every
slot in both packages, which no later slot reads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from glimpseprune_tpu.ops import attention as jax_attention
from glimpseprune_tpu.ops import kv_cache as jax_kv
from test_torch_inputs import make_setup

ATOL = 1e-5
# the chunked and the monolithic prefill attend in another order: the
# JAX package's own test holds their logits to 2e-4
LOGIT_TOL = 2e-4
# int8 caches built from two fp32 schedules: a value may round to the
# other side of a half step, the scales agree to fp32 rounding
CACHE_RTOL = 1e-5


def _t(a):
    import torch

    return torch.as_tensor(np.array(a))


def _with_kv(cfg, tier):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, kv_cache_quant=tier))


def _runners(cfg, s):
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    return (jax_runner.GlimpsePruneRunner(cfg, s.params, donate_cache=False),
            GlimpsePruneRunner(cfg, s.tmodel))


def _attention_case(seed, s_new, t=12, b=2, hq=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (normal(b, s_new, hq, d), normal(b, t, hkv, d), normal(b, t, hkv, d),
            normal(b, s_new, hkv, d), normal(b, s_new, hkv, d))


def _caches(kc, vc, tier):
    """(JAX caches, port caches) of kc / vc in a cache tier."""
    import torch

    from glimpseprune_torch.ops import kv_cache

    if tier == "none":
        return (jnp.asarray(kc), jnp.asarray(vc)), (torch.as_tensor(kc), torch.as_tensor(vc))
    jc, tc = [], []
    for a in (kc, vc):
        q, s = jax_kv.quantize_kv(jnp.asarray(a))
        jc.append({"q": q, "s": s})
        q, s = kv_cache.quantize_kv(torch.as_tensor(a))
        tc.append({"q": q, "s": s})
    return jc, tc


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_decode_attention_new_valid_matches_jax(tier):
    """A chunk of 4 at slot 6 of row 1's cache whose first two tokens are
    left pads (new_valid False), row 0 all real: JAX's output on the real
    queries."""
    from glimpseprune_torch.ops import attention

    s_new, write_idx = 4, 6
    q, kc, vc, kn, vn = _attention_case(7, s_new)
    kv_valid = np.zeros((2, 12), bool)
    kv_valid[0, :write_idx + s_new] = True
    kv_valid[1, write_idx + 2:write_idx + s_new] = True  # the row starts in this chunk
    new_valid = kv_valid[:, write_idx:write_idx + s_new]
    (jk, jv), (tk, tv) = _caches(kc, vc, tier)
    want = jax_attention.decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(kv_valid), k_new=jnp.asarray(kn),
        v_new=jnp.asarray(vn), write_idx=jnp.int32(write_idx), new_valid=jnp.asarray(new_valid))
    got = attention.decode_attention(_t(q), tk, tv, _t(kv_valid), _t(kn), _t(vn), write_idx,
                                     _t(new_valid))
    rows = new_valid  # queries at real slots
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows], atol=ATOL, rtol=0)
    # the pads change the real rows' output: the mask is applied
    unmasked = attention.decode_attention(_t(q), tk, tv, _t(kv_valid), _t(kn), _t(vn),
                                          write_idx)
    assert np.abs(unmasked.numpy()[1, 2:] - got.numpy()[1, 2:]).max() > 1e-3


@pytest.mark.parametrize("s_new", [1, 3])
@pytest.mark.parametrize("tier", ["none", "int8"])
def test_decode_attention_legacy_matches_jax(tier, s_new):
    """k_new None: the queries attend over the valid cache slots, the last
    s_new of which are their own (causal among themselves); row 1 left
    padded."""
    from glimpseprune_torch.ops import attention

    q, kc, vc, _, _ = _attention_case(8, s_new)
    kv_valid = np.ones((2, 12), bool)
    kv_valid[1, :5] = False
    (jk, jv), (tk, tv) = _caches(kc, vc, tier)
    want = jax_attention.decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(kv_valid))
    got = attention.decode_attention(_t(q), tk, tv, _t(kv_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _chunk_inputs(s, jr):
    """(embeds, position_ids, valid) of the JAX unpruned prefill of the
    shared batch, its glimpse slots dropped."""
    cfg = s.cfg
    inputs = jr._device_inputs(s.prep_j, False)
    le = cfg.gp.le_length if cfg.gp.has_le else 0
    ids, valid = inputs["input_ids"][:, :-le], inputs["valid"][:, :-le]
    pos = inputs["position_ids"][:, :, :-le]
    image_embeds = jr._vision({"params": jr.params}, inputs["patches"], inputs["vis_pos_ids"],
                              inputs["full_seg"], inputs["vis_valid"])[0]
    embeds = jr._embed_imgs({"params": jr.params}, ids, image_embeds, inputs["packed_idx"],
                            inputs["img_slots"], inputs["img_valid"])
    return embeds, pos, valid


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_prefill_chunk_and_decode_step_match_jax(tier):
    """The second chunk of 8 of the unpruned prefill (its first written by
    JAX's ``prefill_chunk`` into both packages' caches), its left-padded
    row's pads inside the first chunk: ``prefill_chunk`` and
    ``TextDecoder.decode_step`` with inputs_embeds / logits_index /
    new_valid give JAX's logits at slot 5 and its caches. The int8 tier's
    caches are written as the decode writes them."""
    import torch

    from glimpseprune_torch.ops import kv_cache

    s = make_setup()
    cfg = _with_kv(s.cfg, tier)
    jr, tr = _runners(cfg, s)
    embeds, pos, valid = _chunk_inputs(s, jr)
    assert not bool(valid[1, 0])  # row 1 is left padded into the first chunk
    b, c = valid.shape[0], 8
    t = 2 * c + 3
    quant = "" if tier == "none" else tier
    shape = (cfg.text.num_hidden_layers, b, t, cfg.text.num_key_value_heads, cfg.text.head_dim)
    kv_valid = jnp.concatenate([valid[:, :2 * c], jnp.zeros((b, t - 2 * c), bool)], 1)
    caches = [jax_kv.alloc_cache(shape, jnp.float32, quant) for _ in range(2)]
    _, kc, vc = s.jmodel.apply({"params": s.params}, embeds[:, :c], pos[:, :, :c], *caches,
                               kv_valid, jnp.int32(0), kv_valid[:, :c], jnp.int32(c - 1),
                               method=s.jmodel.prefill_chunk)

    def port_caches():
        if tier == "none":
            return _t(kc), _t(vc)
        return tuple({k: _t(x[k]) for k in ("q", "s")} for x in (kc, vc))

    args = (embeds[:, c:2 * c], pos[:, :, c:2 * c], kc, vc, kv_valid, jnp.int32(c),
            kv_valid[:, c:2 * c], jnp.int32(5))
    want = s.jmodel.apply({"params": s.params}, *args, method=s.jmodel.prefill_chunk)
    got = s.tmodel.prefill_chunk(_t(args[0]), _t(args[1]), *port_caches(), _t(kv_valid), c,
                                 _t(args[6]), torch.tensor(5))
    cos, sin = s.tmodel._cos_sin(_t(args[1]))
    via_text = s.tmodel.text.decode_step(None, cos, sin, *port_caches(), _t(kv_valid),
                                         torch.tensor(c), inputs_embeds=_t(args[0]),
                                         logits_index=torch.tensor(5), new_valid=_t(args[6]))
    w = np.asarray(want[0])
    assert got[0].shape == w.shape == (b, 1, cfg.text.vocab_size)
    for res in (got, via_text):
        np.testing.assert_allclose(res[0].numpy(), w, atol=LOGIT_TOL * np.abs(w).max(), rtol=0)
        for g, wc in zip(res[1:], want[1:]):
            if tier == "none":
                np.testing.assert_allclose(g.numpy(), np.asarray(wc),
                                           atol=CACHE_RTOL * np.abs(np.asarray(wc)).max())
            else:
                dq = np.abs(g["q"].numpy().astype(np.int32) - np.asarray(wc["q"], np.int32))
                assert dq.max() <= 1 and (dq > 0).mean() < 1e-3
                np.testing.assert_allclose(g["s"].numpy(), np.asarray(wc["s"]),
                                           rtol=CACHE_RTOL)
    # the head ran on one slot: the logits at slot 5 of the whole chunk's
    whole = s.tmodel.text.decode_step(None, cos, sin, *port_caches(), _t(kv_valid), c,
                                      inputs_embeds=_t(args[0]), new_valid=_t(args[6]))[0]
    assert whole.shape[1] == c
    np.testing.assert_allclose(whole[:, 5:6].numpy(), got[0].numpy(), atol=1e-6, rtol=0)
    assert isinstance(got[1], (dict, torch.Tensor)) and kv_cache.cache_t(got[1]) == t


def test_embed_with_images_text_only_matches_jax():
    s = make_setup()
    ids = np.random.default_rng(9).integers(5, 400, (2, 7)).astype(np.int32)
    want = s.jmodel.apply({"params": s.params}, jnp.asarray(ids),
                          method=s.jmodel.embed_with_images)
    got = s.tmodel.embed_with_images(_t(ids).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _seq_len(s):
    le = s.cfg.gp.le_length if s.cfg.gp.has_le else 0
    return int(s.prep_t.input_ids.shape[1]) - le


@pytest.mark.parametrize("chunk", [8, 16, 7, 64])
def test_chunked_prefill_matches_jax_and_monolithic(chunk):
    """Chunks of 8 and 16, of 7 (no divisor of S: the tail chunk is padded
    and the head runs mid-chunk) and of 64 (one chunk past S): the logits
    within LOGIT_TOL of JAX's chunked prefill and of the port's monolithic
    unpruned prefill; the decode over the chunked cache (``prealloc_t``)
    gives JAX's unpruned generate tokens."""
    s = make_setup()
    jr, tr = _runners(s.cfg, s)
    seq = _seq_len(s)
    max_new = 6
    t = seq + max_new + 32
    logits, valid, pos, kc, vc = tr.vanilla_prefill_chunked(s.prep_t, chunk, prealloc_t=t)
    n_chunks = -(-seq // chunk)
    assert kc.shape[2] == max(t, n_chunks * chunk) and valid.shape == (2, seq)
    want = jr.vanilla_prefill_chunked(s.prep_j, chunk_size=chunk)
    mono = tr.prefill(s.prep_t, do_selection=False)
    for ref in (np.asarray(want[0]), mono.logits.numpy()):
        np.testing.assert_allclose(logits.numpy(), ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want[2]))
    seqs, n_gen = tr._decode_loop(logits, valid, pos, kc, vc, max_new, s.cfg.eos_token_id,
                                  prealloc_t=kc.shape[2])
    base = jr.generate(s.prep_j, max_new_tokens=max_new, do_selection=False)
    np.testing.assert_array_equal(seqs, np.asarray(base.sequences))
    np.testing.assert_array_equal(n_gen, np.asarray(base.num_generated))


def test_chunked_prefill_int8_kv_matches_monolithic():
    """Under the int8 KV tier the chunked prefill quantizes its cache once,
    at the end: the monolithic prefill's decode cache at the real slots up
    to a rounding tie (scales to fp32 rounding), and the same greedy tokens as the unpruned
    generate of the port and of JAX."""
    from glimpseprune_torch.ops import kv_cache

    s = make_setup()
    cfg = _with_kv(s.cfg, "int8")
    jr, tr = _runners(cfg, s)
    seq, max_new = _seq_len(s), 5
    logits, valid, pos, kc, vc = tr.vanilla_prefill_chunked(s.prep_t, 8,
                                                            prealloc_t=seq + max_new + 32)
    assert kv_cache.is_quantized(kc) and kc["q"].dtype.itemsize == 1
    mono = tr.prefill(s.prep_t, do_selection=False)
    real = valid.numpy()  # pad slots' kv follow each path's pad rows
    for got, kv in ((kc, mono.kv_k), (vc, mono.kv_v)):
        want = tr.decode_cache(kv, kv_cache.cache_t(got))
        g, w = ({k: c[k][:, :, :seq].numpy()[:, real] for k in ("q", "s")} for c in (got, want))
        dq = np.abs(g["q"].astype(np.int32) - w["q"].astype(np.int32))
        assert dq.max() <= 1 and (dq > 0).mean() < 1e-3
        np.testing.assert_allclose(g["s"], w["s"], rtol=CACHE_RTOL)
    seqs, _ = tr._decode_loop(logits, valid, pos, kc, vc, max_new, cfg.eos_token_id,
                              prealloc_t=kv_cache.cache_t(kc))
    for base in (tr.generate(s.prep_t, max_new_tokens=max_new, do_selection=False),
                 jr.generate(s.prep_j, max_new_tokens=max_new, do_selection=False)):
        np.testing.assert_array_equal(seqs, np.asarray(base.sequences))


def test_chunked_prefill_steps_yields_between_chunks():
    """The generator yields n_chunks - 1 times and returns the chunked
    prefill with raw kv sliced to the S slots, the monolithic prefill's kv
    at the real ones, also under the int8 KV tier, whose rounding the
    batcher applies at fill."""
    s = make_setup()
    cfg = _with_kv(s.cfg, "int8")
    _, tr = _runners(cfg, s)
    seq, chunk = _seq_len(s), 8
    gen = tr.vanilla_prefill_chunked_steps(s.prep_t, chunk)
    yields = []
    while True:
        try:
            yields.append(next(gen))
        except StopIteration as stop:
            logits, valid, pos, kv_k, kv_v = stop.value
            break
    assert yields == list(range(-(-seq // chunk) - 1))
    mono = tr.prefill(s.prep_t, do_selection=False)
    assert kv_k.shape == mono.kv_k.shape and kv_k.dtype == mono.kv_k.dtype
    real = valid.numpy()  # pad slots' kv follow each package's pad rows
    for got, want in ((kv_k, mono.kv_k), (kv_v, mono.kv_v)):
        g, w = got.numpy()[:, real], want.numpy()[:, real]
        np.testing.assert_allclose(g, w, atol=LOGIT_TOL * np.abs(w).max(), rtol=0)
    np.testing.assert_allclose(logits.numpy(), mono.logits.numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)

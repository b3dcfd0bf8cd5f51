"""The port's decode (glimpseprune_torch: ``Qwen2_5_VL_GP.decode_chunk`` /
``decode_step``, the runner's ``_decode_loop`` / ``_run_decode`` /
``stream_generate`` / ``generate(check_eos_every=, temperature=, rng=)``,
``ops/kv_cache.cache_fill_rows``, and the captured step's bookkeeping in
``decode_graph.py``) against the JAX package's on the same tiny weights and
inputs, fp32 on the CPU, where the step runs eagerly:

- ``decode_chunk`` from the same prefill outputs: tokens, next token and
  done flags equal; fp32 caches within 1e-5 of their largest entry (the
  two packages' fp32 sums are taken in another order); int8 caches equal
  in their scales to fp32 rounding and in their values to one step at a
  rounding tie;
- chunk invariance, ``check_eos_every``, ``stream_generate`` (blocks,
  sequences, counts, keep sets), 40-token decodes across the 32-step chunk
  with and without a stop sequence in every weight tier, ``prealloc_t``
  decode over a cache assembled by ``cache_fill_rows`` from two B=1
  prefills, ``decode_step`` with 1 and 3 new tokens: equal to JAX;
- sampling: the Gumbel-max draw has the distribution softmax(logits / T)
  (chi-square), a seed fixes the tokens, a tiny temperature gives the
  greedy ones (``jax.random`` draws cannot be matched bit for bit);
- the CPU path touches no CUDA API; a captured step's launch counts are
  taken out of the capture and added per replay; the runner's graphs are
  kept by key, the oldest dropped; a graph kept for the caller's cache
  holds no reference to it.
"""

import dataclasses
import gc
import weakref
from collections import Counter
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from glimpseprune_tpu.ops import attention as jax_attention
from glimpseprune_tpu.ops import kv_cache as jax_kv
from test_torch_inputs import make_batch_args, make_setup

# the two packages' fp32 sums are taken in another order: ~1e-6 of the
# largest entry through the tiny model's layers
CACHE_RTOL = 1e-5
LOGIT_RTOL = 1e-4


def _t(a):
    import torch

    return torch.as_tensor(np.array(a))


def _with_kv(cfg, tier):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, kv_cache_quant=tier))


def _runners(cfg, s, tcfg=None, params=None, model=None):
    """(the JAX runner, the port's runner) on the shared weights, or on a
    tier's (its port config, quantized JAX params and port model)."""
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    return (jax_runner.GlimpsePruneRunner(cfg, s.params if params is None else params),
            GlimpsePruneRunner(cfg if tcfg is None else tcfg,
                               s.tmodel if model is None else model))


def _prefill_args(out):
    """(logits, valid, position_ids, kv_k, kv_v) of a JAX prefill, for JAX
    and as torch tensors."""
    j = (out.logits, out.valid, out.position_ids, out.kv_k, out.kv_v)
    return j, tuple(_t(a) for a in j)


def _drain(gen):
    blocks = []
    while True:
        try:
            blocks.append(np.asarray(next(gen)))
        except StopIteration as stop:
            return blocks, stop.value


def _assert_cache_close(got, want):
    if isinstance(want, dict):
        q_got, q_want = got["q"].numpy().astype(np.int32), np.asarray(want["q"], np.int32)
        assert np.abs(q_got - q_want).max() <= 1  # a rounding tie may fall either way
        assert (q_got != q_want).mean() < 1e-3
        np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]), rtol=CACHE_RTOL)
        return
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, atol=CACHE_RTOL * np.abs(w).max(), rtol=0)


@pytest.fixture
def flash_interpret():
    old = jax_attention.ATTENTION_IMPL
    jax_attention.ATTENTION_IMPL = "flash_interpret"
    yield
    jax_attention.ATTENTION_IMPL = old


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_decode_chunk_matches_jax(tier):
    """From the JAX prefill's outputs, with an eos that row 0 emits inside
    the chunk: the same tokens, next token, done flags, kv_valid and
    caches."""
    import torch

    s = make_setup()
    cfg = _with_kv(s.cfg, tier)
    jr, tr = _runners(cfg, s)
    (logits, valid, pos, kv_k, kv_v), tj = _prefill_args(jr.glimpse(s.prep_j))
    b, r = valid.shape
    n, t = 6, valid.shape[1] + 6
    first = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)

    def run_jax(eos):
        quant = "" if tier == "none" else tier
        kvv = jnp.concatenate([valid, jnp.zeros((b, t - r), bool)], 1)
        return s.jmodel.apply(
            {"params": s.params}, first, pos[:, :, -1],
            jax_runner._build_decode_cache(kv_k, t=t, quant=quant),
            jax_runner._build_decode_cache(kv_v, t=t, quant=quant), kvv, jnp.int32(r),
            jax.random.PRNGKey(0), n_steps=n, eos_token_id=eos, method=s.jmodel.decode_chunk)

    eos = int(np.asarray(run_jax(cfg.eos_token_id)[0])[0, 3])
    want = run_jax(eos)
    kvv = torch.cat([tj[1], torch.zeros((b, t - r), dtype=torch.bool)], 1)
    got = s.tmodel.decode_chunk(_t(first).long(), tj[2][:, :, -1], tr.decode_cache(tj[3], t),
                                tr.decode_cache(tj[4], t), kvv, r, None, n, eos)
    for name, g, w in zip(("toks", "next", "done", "kv_valid"), got[:3] + got[5:],
                          want[:3] + want[5:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[2].numpy().tolist() != [False, False]  # row 0 finished in the chunk
    for g, w in zip(got[3:5], want[3:5]):
        _assert_cache_close(g, w)


def test_chunk_size_changes_no_token():
    """Chunks of 7 and of 2 give the same tokens, and JAX's chunk of 7."""
    s = make_setup()
    jr, tr = _runners(s.cfg, s)
    pre = tr.prefill(s.prep_t)
    args = (pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v)
    big = tr._decode_loop(*args, 7, s.cfg.eos_token_id, chunk_size=7)
    small = tr._decode_loop(*args, 7, s.cfg.eos_token_id, chunk_size=2)
    out = jr.glimpse(s.prep_j)
    want = jr._decode_loop(out.logits, out.valid, out.position_ids, out.kv_k, out.kv_v, 7,
                           s.cfg.eos_token_id, chunk_size=7)
    for got in (big, small):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_check_eos_every_changes_chunking_not_tokens():
    """With an eos that row 0 emits at step 4: the same trimmed tokens and
    counts with the default chunk and with checks every 3 steps, and the
    JAX runner's."""
    s = make_setup()
    jr, tr = _runners(s.cfg, s)
    eos = int(tr.generate(s.prep_t, max_new_tokens=7).sequences[0, 4])
    a = tr.generate(s.prep_t, max_new_tokens=7, eos_token_id=eos)
    b = tr.generate(s.prep_t, max_new_tokens=7, eos_token_id=eos, check_eos_every=3)
    want = jr.generate(s.prep_j, max_new_tokens=7, eos_token_id=eos, check_eos_every=3)
    assert a.num_generated[0] == 5
    for got in (a, b):
        np.testing.assert_array_equal(got.sequences, want.sequences)
        np.testing.assert_array_equal(got.num_generated, want.num_generated)


@pytest.mark.parametrize("chunk,stop", [(3, False), (2, True)])
def test_stream_generate_matches_jax(chunk, stop):
    """The streamed blocks, then the result: sequences, counts, keep sets
    (a stop sequence from row 0's tokens 2-3 in the second case)."""
    s = make_setup()
    jr, tr = _runners(s.cfg, s)
    stops = None
    if stop:
        base = tr.generate(s.prep_t, max_new_tokens=8).sequences
        stops = [[int(base[0, 2]), int(base[0, 3])]]
    want_blocks, want = _drain(jr.stream_generate(s.prep_j, max_new_tokens=8, chunk_size=chunk,
                                                  stop_sequences=stops))
    got_blocks, got = _drain(tr.stream_generate(s.prep_t, max_new_tokens=8, chunk_size=chunk,
                                                stop_sequences=stops))
    assert len(got_blocks) == len(want_blocks) and got_blocks[0].shape == (2, chunk)
    for g, w in zip(got_blocks, want_blocks):
        np.testing.assert_array_equal(g, w)
    for field in ("sequences", "num_generated", "keep_img"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    if stop:
        assert got.num_generated[0] == 2


@pytest.mark.parametrize("tier", ["none", "q8", "q4"])
def test_long_decode_across_chunks_matches_jax(tier, flash_interpret):
    """40 greedy tokens cross the 32-step chunk: the JAX runner's tokens in
    every weight tier, pruned, and again with a stop sequence that matches
    in the second chunk."""
    from test_torch_quant_runner import _tier

    if tier == "none":
        s = make_setup()
        jr, tr = _runners(s.cfg, s)
    else:
        s, jcfg, qparams, tcfg, tmodel = _tier(tier)
        jr, tr = _runners(jcfg, s, tcfg, qparams, tmodel)
    want = jr.generate(s.prep_j, max_new_tokens=40)
    got = tr.generate(s.prep_t, max_new_tokens=40)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.num_generated, want.num_generated)
    stops = [[int(want.sequences[0, 34]), int(want.sequences[0, 35])]]
    want = jr.generate(s.prep_j, max_new_tokens=40, stop_sequences=stops)
    got = tr.generate(s.prep_t, max_new_tokens=40, stop_sequences=stops)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.num_generated, want.num_generated)
    assert got.num_generated[0] <= 34


@pytest.mark.parametrize("b0", [0, 1])
@pytest.mark.parametrize("tier", ["none", "int8"])
def test_cache_fill_rows_matches_jax(tier, b0):
    import torch

    from glimpseprune_torch.ops import kv_cache

    rng = np.random.default_rng(4)
    shape = (3, 3, 10, 2, 8)
    kv = rng.standard_normal((3, 2, 7, 2, 8)).astype(np.float32)
    want = jax_kv.cache_fill_rows(jax_kv.alloc_cache(shape, jnp.float32,
                                                     "" if tier == "none" else tier),
                                  jnp.asarray(kv), jnp.int32(b0))
    got = kv_cache.alloc_cache(shape, torch.float32, "cpu", tier)
    assert kv_cache.cache_fill_rows(got, torch.as_tensor(kv), b0) is got
    assert kv_cache.cache_t(got) == jax_kv.cache_t(want) == 10
    if tier == "none":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        for key in ("q", "s"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_prealloc_decode_matches_jax_assembly(tier):
    """Two B=1 pruned prefills (rows of the shared batch, one out_len),
    filled into one B=2 cache of T slots with cache_fill_rows and decoded
    with prealloc_t = T: JAX's tokens from the same assembly, and the
    port's own default path over the two rows' KV; a prealloc_t below R +
    the rounded new tokens raises, as in JAX."""
    import torch

    from glimpseprune_torch.ops import kv_cache

    s = make_setup()
    cfg = _with_kv(s.cfg, tier)
    jr, tr = _runners(cfg, s)
    prompts, images, kwargs = make_batch_args(cfg)
    preps = [jax_runner.prepare_inputs(cfg, [prompts[i]], [images[i]], **kwargs)
             for i in range(2)]
    r = max(p.out_len for p in preps)
    outs = [jr.glimpse(dataclasses.replace(p, out_len=r)) for p in preps]
    n, t = 8, r + 8 + 3
    eos = s.cfg.eos_token_id
    shape = (cfg.text.num_hidden_layers, 2, t, cfg.text.num_key_value_heads,
             cfg.text.head_dim)
    cat = [jnp.concatenate([getattr(o, f) for o in outs], axis=ax)
           for f, ax in (("logits", 0), ("valid", 0), ("position_ids", 1))]
    caches_j = [jax_kv.alloc_cache(shape, jnp.float32, "" if tier == "none" else tier)
                for _ in range(2)]
    caches_t = [kv_cache.alloc_cache(shape, torch.float32, "cpu", tier) for _ in range(2)]
    for i, o in enumerate(outs):
        for c in range(2):
            kv = (o.kv_k, o.kv_v)[c]
            caches_j[c] = jax_kv.cache_fill_rows(caches_j[c], kv, jnp.int32(i))
            kv_cache.cache_fill_rows(caches_t[c], _t(kv), i)
    want = jr._decode_loop(*cat, *caches_j, n, eos, chunk_size=n, prealloc_t=t)
    got = tr._decode_loop(*(_t(a) for a in cat), *caches_t, n, eos, chunk_size=n,
                          prealloc_t=t)
    kv_cat = [_t(jnp.concatenate([getattr(o, f) for o in outs], axis=1))
              for f in ("kv_k", "kv_v")]
    default = tr._decode_loop(*(_t(a) for a in cat), *kv_cat, n, eos, chunk_size=n)
    for res in (got, default):
        np.testing.assert_array_equal(res[0], want[0])
        np.testing.assert_array_equal(res[1], want[1])
    with pytest.raises(ValueError, match="prealloc_t"):
        tr._decode_loop(*(_t(a) for a in cat), *caches_t, n, eos, chunk_size=n,
                        prealloc_t=r + 4)


@pytest.mark.parametrize("slot", ["int", "tensor"])
@pytest.mark.parametrize("s_new", [1, 3])
def test_decode_step_matches_jax(s_new, slot):
    """S_new tokens against the prefill's cache at slot R (an int, or a 0-d
    tensor as the captured step passes it): logits and both caches."""
    import torch

    s = make_setup()
    jr, tr = _runners(s.cfg, s)
    (_, valid, pos, kv_k, kv_v), tj = _prefill_args(jr.glimpse(s.prep_j))
    b, r = valid.shape
    t = r + 4
    ids = np.random.default_rng(5).integers(5, 400, (b, s_new)).astype(np.int32)
    new_pos = pos[:, :, -1:] + 1 + jnp.arange(s_new)
    kvv = jnp.concatenate([valid, jnp.ones((b, s_new), bool), jnp.zeros((b, 4 - s_new), bool)],
                          1)
    want = s.jmodel.apply({"params": s.params}, jnp.asarray(ids), new_pos,
                          jax_runner._build_decode_cache(kv_k, t=t, quant=""),
                          jax_runner._build_decode_cache(kv_v, t=t, quant=""), kvv,
                          jnp.int32(r), method=s.jmodel.decode_step)
    write_idx = r if slot == "int" else torch.tensor(r)
    got = s.tmodel.decode_step(_t(ids).long(), _t(new_pos), tr.decode_cache(tj[3], t),
                               tr.decode_cache(tj[4], t), _t(kvv), write_idx)
    w = np.asarray(want[0])
    assert got[0].shape == (b, s_new, s.cfg.text.vocab_size)
    np.testing.assert_allclose(got[0].numpy(), w, atol=LOGIT_RTOL * np.abs(w).max(), rtol=0)
    for g, wc in zip(got[1:], want[1:]):
        _assert_cache_close(g, wc)


def test_gumbel_max_sampler_has_the_softmax_distribution():
    """20000 draws on fixed logits at T = 0.7: a chi-square test against
    softmax(logits / T) at p > 1e-3."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.gp_model import sample_next

    n, v, temp = 20000, 12, 0.7
    logits = torch.as_tensor(np.random.default_rng(6).standard_normal(v).astype(np.float32))
    noise = torch.rand((n, v), generator=torch.Generator().manual_seed(7))
    draws = sample_next(logits.expand(n, v), torch.tensor(temp), noise)
    counts = np.bincount(draws.numpy(), minlength=v)
    p = np.exp(logits.double().numpy() / temp)
    expected = n * p / p.sum()
    assert expected.min() > 5
    assert stats.chisquare(counts, expected).pvalue > 1e-3


def test_sampled_generate_seeded_and_tiny_temperature_greedy():
    """A generator seed fixes the sampled tokens (another seed changes
    them), and a temperature of 1e-6 gives the greedy tokens."""
    import torch

    s = make_setup()
    _, tr = _runners(s.cfg, s)

    def sampled(seed, temp=1.0):
        return tr.generate(s.prep_t, max_new_tokens=8, temperature=temp,
                           rng=torch.Generator().manual_seed(seed)).sequences

    np.testing.assert_array_equal(sampled(3), sampled(3))
    assert (sampled(3) != sampled(4)).any()
    np.testing.assert_array_equal(sampled(3, 1e-6),
                                  tr.generate(s.prep_t, max_new_tokens=8).sequences)


def test_cpu_decode_touches_no_cuda(monkeypatch):
    """On a CPU model the step runs eagerly: greedy, sampled and streamed
    decodes run with torch.cuda's graph and stream APIs made to raise."""
    import torch

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path touched torch.cuda")

    for name in ("CUDAGraph", "graph", "Stream", "current_stream", "stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    s = make_setup()
    _, tr = _runners(s.cfg, s)
    tr.generate(s.prep_t, max_new_tokens=3)
    tr.generate(s.prep_t, max_new_tokens=3, temperature=0.5)
    blocks, res = _drain(tr.stream_generate(s.prep_t, max_new_tokens=3, chunk_size=2))
    assert len(blocks) == 2 and res.sequences.shape == (2, 3)


class _FakeCuda:
    """Stand-ins for torch.cuda's graph API that run a capture's Python
    and record what replays ran."""

    def __init__(self):
        self.replays, self.capturing = 0, False

    def install(self, monkeypatch):
        import contextlib

        import torch

        fake = self

        class Graph:
            def capture_begin(self, pool=None, capture_error_mode="global"):
                fake.capturing = True

            def capture_end(self):
                fake.capturing = False

            def replay(self):
                fake.replays += 1

            def pool(self):
                return ("pool",)

        stream = SimpleNamespace(device="cpu", wait_stream=lambda other: None)
        monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
        monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
        monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())


def test_replays_count_the_captured_launches(monkeypatch):
    """A step that launches K4 three times: the warm-up counts 3, the
    capture nothing (its Python ran, no kernel did), each replay 3."""
    from glimpseprune_torch.models.qwen2_5_vl import decode_graph
    from glimpseprune_torch.ops.cuda.int4_matmul import matmul_int4

    fake = _FakeCuda()
    fake.install(monkeypatch)
    monkeypatch.setattr(matmul_int4, "launches", Counter())

    class Model:
        captured = 0

        def decode_state_step(self, state):
            Model.captured += fake.capturing
            matmul_int4.launches["3584x512"] += 3

    state = SimpleNamespace(draw_noise=lambda rng: None)
    graph = decode_graph.StepGraph(Model(), state, decode_graph.torch.cuda.Stream())
    assert Model.captured == 1 and not fake.capturing
    assert matmul_int4.launches == Counter({"3584x512": 3})
    assert graph.per_replay == {(matmul_int4, "3584x512"): 3}
    graph.run(4)
    assert fake.replays == 4 and matmul_int4.launches["3584x512"] == 15


def test_graphs_kept_by_key_oldest_dropped(monkeypatch):
    """A new key's state is begun before its capture (so the warm-up
    writes at write_start) and again before use; a kept key is only begun;
    past MAX_GRAPHS the least recently used key goes."""
    from glimpseprune_torch.models.qwen2_5_vl import decode_graph

    _FakeCuda().install(monkeypatch)
    monkeypatch.setattr(decode_graph, "MAX_GRAPHS", 2)
    model = SimpleNamespace(decode_state_step=lambda state: None)
    graphs = decode_graph.DecodeGraphs(model)
    begun = Counter()

    def make_state():
        return SimpleNamespace(tok=SimpleNamespace(device="cpu"), draw_noise=lambda rng: None)

    def steps(key):
        return graphs.steps(key, make_state, lambda st: begun.update([key]))

    a = steps("a")
    assert begun["a"] == 2 and steps("a") is a and begun["a"] == 3
    steps("b")
    steps("a")
    steps("c")  # drops b, the least recently used
    assert list(graphs._graphs) == ["a", "c"]
    assert steps("b") is not None and list(graphs._graphs) == ["c", "b"]


def test_kept_prealloc_graph_pins_no_cache(monkeypatch):
    """A graph kept for the caller's cache (``prealloc_t``) is keyed by its
    address and holds no reference to it: the cache is freed once the
    caller drops it."""
    from glimpseprune_torch.ops import kv_cache

    _FakeCuda().install(monkeypatch)
    s = make_setup()
    _, tr = _runners(s.cfg, s)
    pre = tr.prefill(s.prep_t)
    r, n = pre.valid.shape[1], 4
    shape = pre.kv_k.shape[:2] + (r + n,) + pre.kv_k.shape[3:]
    caches = [kv_cache.alloc_cache(shape, pre.kv_k.dtype, "cpu", "none") for _ in range(2)]
    for i, kv in enumerate((pre.kv_k, pre.kv_v)):
        kv_cache.cache_set_prefix(caches[i], kv)
    monkeypatch.setattr(tr, "device", SimpleNamespace(type="cuda"))  # capture, faked
    tr._decode_loop(pre.logits, pre.valid, pre.position_ids, *caches, n, -1, chunk_size=n,
                    prealloc_t=r + n)
    (graph,) = tr.decode_graphs._graphs.values()
    assert graph.state.k_cache is None and graph.state.v_cache is None
    refs = [weakref.ref(c) for c in caches]
    del caches
    gc.collect()
    assert all(ref() is None for ref in refs)

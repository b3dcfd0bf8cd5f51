"""The port's ContinuousBatcher (glimpseprune_torch/serving.py) against the
JAX package's (glimpseprune_tpu/serving.py) on the same tiny weights and
inputs, fp32 on the CPU, where its decode step runs eagerly: the five CPU
tests of tests/test_serving.py ported. The scheduler is a pure
re-arrangement of work: every request's greedy tokens equal JAX's batcher's
and JAX's and the port's generate() tokens (the global cursor's gaps and
the other rows' lanes are masked out of attention), slots are reused, eos
completes a row early. Sampling is held against the port's own sampled
generate at the same torch.Generator seed (JAX draws from PRNG keys).
Also: a second serve() of the same batcher gives the same tokens and
captures no second step, and admission clears its slot's whole kv_valid
lane and restarts its done flag.

test_serving.py's test_continuous_matches_generate_on_mesh waits for the
port's dp / tp parallelism.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from glimpseprune_tpu.serving import ContinuousBatcher as JaxBatcher
from test_torch_inputs import make_batch_args, make_setup


def _runners(s):
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    return (jax_runner.GlimpsePruneRunner(s.cfg, s.params, donate_cache=False),
            GlimpsePruneRunner(s.cfg, s.tmodel))


def _one_row(out):
    """A B=2 prefill's (logits, valid, position_ids, kv_k, kv_v) -> row 0's."""
    logits, valid, pos, kc, vc = out[:5]
    return logits[:1], valid[:1], pos[:, :1], kc[:, :1], vc[:, :1]


def _prefills(jr, tr, s):
    """Row 0's B=1 slice of the shared batch's pruned prefill: (JAX thunk,
    port thunk, R)."""
    dev = jr._device_inputs(s.prep_j, use_ref_masks=False)

    def jax_prefill():
        o = jr._prefill({"params": jr.params}, dev, out_len=s.prep_j.out_len,
                        use_ref_masks=False)
        return _one_row((o.logits, o.valid, o.position_ids, o.kv_k, o.kv_v))

    def port_prefill():
        return _one_row(tr.prefill(s.prep_t))

    return jax_prefill, port_prefill, int(port_prefill()[1].shape[1])


def _batchers(jr, tr, **kw):
    from glimpseprune_torch.serving import ContinuousBatcher

    return JaxBatcher(jr, **kw), ContinuousBatcher(tr, **kw)


def test_continuous_matches_generate_with_slot_reuse():
    """Capacity 2 < 3 requests: the third waits for a freed slot. Every
    request's tokens are JAX's batcher's and both generate()s' row 0."""
    max_new = 8
    s = make_setup()
    jr, tr = _runners(s)
    jp, tp, r = _prefills(jr, tr, s)
    jb, tb = _batchers(jr, tr, capacity=2, prefix_len=r, max_new_tokens=max_new,
                       inter_steps=2, eos=-1, max_requests=3)
    seqs, n_gen, ttft, completion = tb.serve([tp] * 3)
    want = jb.serve([jp] * 3)
    expect = tr.generate(s.prep_t, max_new_tokens=max_new).sequences[0]
    np.testing.assert_array_equal(
        expect, np.asarray(jr.generate(s.prep_j, max_new_tokens=max_new).sequences)[0])
    np.testing.assert_array_equal(seqs, want[0])
    np.testing.assert_array_equal(n_gen, want[1])
    for i in range(3):
        np.testing.assert_array_equal(seqs[i], expect)
    assert (n_gen == max_new).all()
    assert ttft[2] > max(ttft[0], ttft[1])
    assert (completion >= ttft).all()


def test_continuous_eos_early_exit_frees_slot():
    """An eos at the first new token value: every request stops there,
    eos-padded after, and at capacity 1 the second request starts after
    the first completes; JAX's batcher gives the same."""
    max_new = 8
    s = make_setup()
    jr, tr = _runners(s)
    jp, tp, r = _prefills(jr, tr, s)
    expect = tr.generate(s.prep_t, max_new_tokens=max_new).sequences[0]
    idx = next(i for i in range(1, max_new - 1) if expect[i] not in expect[:i])
    eos = int(expect[idx])
    jb, tb = _batchers(jr, tr, capacity=1, prefix_len=r, max_new_tokens=max_new,
                       inter_steps=2, eos=eos, max_requests=2)
    seqs, n_gen, ttft, completion = tb.serve([tp] * 2)
    want = jb.serve([jp] * 2)
    np.testing.assert_array_equal(seqs, want[0])
    np.testing.assert_array_equal(n_gen, want[1])
    for i in range(2):
        np.testing.assert_array_equal(seqs[i, :idx + 1], expect[:idx + 1])
        assert (seqs[i, idx + 1:] == eos).all()
    assert (n_gen == idx + 1).all()
    assert ttft[1] > completion[0]


def test_continuous_overrun_guard():
    s = make_setup()
    jr, tr = _runners(s)
    _, tp, r = _prefills(jr, tr, s)
    from glimpseprune_torch.serving import ContinuousBatcher

    b = ContinuousBatcher(tr, capacity=1, prefix_len=r, max_new_tokens=4, inter_steps=2,
                          max_requests=1)
    with pytest.raises(ValueError, match="overrun"):
        b.serve([tp] * 5)


def test_continuous_sampled_admission_matches_generate():
    """temperature > 0: a capacity-1 batcher at inter_steps ==
    check_eos_every reproduces the port's sampled generate of the same
    one-row request at the same generator seed, token for token (the
    admission's draw is generate's first-token draw, each replay's the
    step's); its first token is that draw, and the tokens are not the
    greedy ones."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.gp_model import sample_next
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.serving import ContinuousBatcher

    max_new, temp = 8, 2.0
    s = make_setup()
    _, tr = _runners(s)
    prompts, images, kwargs = make_batch_args(s.cfg)
    prep = prepare_inputs(s.cfg, prompts[:1], images[:1], **kwargs)

    def prefill():
        return _one_row(tr.prefill(prep))

    base = tr.generate(prep, max_new_tokens=max_new, temperature=temp,
                       rng=torch.Generator().manual_seed(7), check_eos_every=2)
    b = ContinuousBatcher(tr, capacity=1, prefix_len=int(prefill()[1].shape[1]),
                          max_new_tokens=max_new, inter_steps=2, eos=-1, temperature=temp,
                          max_requests=1)
    seqs, _, _, _ = b.serve([prefill], rng=torch.Generator().manual_seed(7))
    last = prefill()[0][:, -1]
    first = sample_next(last, temp, torch.rand(last.shape,
                                               generator=torch.Generator().manual_seed(7)))
    assert int(seqs[0, 0]) == int(first[0])
    np.testing.assert_array_equal(seqs[0], base.sequences[0])
    assert (seqs[0] != tr.generate(prep, max_new_tokens=max_new).sequences[0]).any()
    other, _, _, _ = b.serve([prefill], rng=torch.Generator().manual_seed(8))
    assert (other != seqs).any()


def test_continuous_chunked_admission_matches_generate():
    """Chunked admissions (``vanilla_prefill_chunked_steps`` generators,
    chunks of 8) give JAX's chunked batcher's tokens and both unpruned
    generate()s' row 0, and running rows decode inside a later request's
    admission."""
    max_new = 8
    s = make_setup()
    jr, tr = _runners(s)
    expect = tr.generate(s.prep_t, max_new_tokens=max_new, do_selection=False).sequences[0]
    np.testing.assert_array_equal(expect, np.asarray(
        jr.generate(s.prep_j, max_new_tokens=max_new, do_selection=False).sequences)[0])
    r = int(tr.vanilla_prefill_chunked(s.prep_t, chunk_size=8)[1].shape[1])
    jb, tb = _batchers(jr, tr, capacity=2, prefix_len=r, max_new_tokens=max_new,
                       inter_steps=2, eos=-1, max_requests=3)
    inside, chunks_inside = [False], []

    def chunked(runner, prep):
        def thunk():
            gen = runner.vanilla_prefill_chunked_steps(prep, chunk_size=8)
            while True:
                try:
                    i = next(gen)
                except StopIteration as stop:
                    return _one_row(stop.value)
                inside[0] = True  # until the batcher resumes the prefill
                yield i
                inside[0] = False
        return thunk

    import torch

    with torch.inference_mode():
        steps = tb._decode_steps()
    run = steps.run

    def counted(n, rng=None):
        if inside[0]:
            chunks_inside.append(n)
        return run(n, rng)

    steps.run = counted
    seqs, n_gen, _, _ = tb.serve([chunked(tr, s.prep_t)] * 3)
    want = jb.serve([chunked(jr, s.prep_j)] * 3)
    np.testing.assert_array_equal(seqs, want[0])
    for i in range(3):
        np.testing.assert_array_equal(seqs[i], expect)
    assert (n_gen == max_new).all()
    assert chunks_inside  # decode chunks ran between a request's prefill chunks


def test_second_serve_gives_the_same_tokens(monkeypatch):
    """The batcher keeps its state and step: a second serve() of the same
    requests begins the state again and gives the same tokens and times in
    the same order, and no second step is made."""
    from glimpseprune_torch import serving

    s = make_setup()
    jr, tr = _runners(s)
    _, tp, r = _prefills(jr, tr, s)
    b = serving.ContinuousBatcher(tr, capacity=2, prefix_len=r, max_new_tokens=6,
                                  inter_steps=3, eos=-1, max_requests=3)
    made = []
    eager = serving.EagerSteps
    monkeypatch.setattr(serving, "EagerSteps", lambda *a: made.append(1) or eager(*a))
    first = b.serve([tp] * 3)
    again = b.serve([tp] * 3)
    assert len(made) == 1
    for x, y in zip(first[:2], again[:2]):
        np.testing.assert_array_equal(x, y)
    assert again[2][2] > max(again[2][:2])


def test_admission_clears_the_lane_and_restarts_done():
    """Admission into a slot whose lane other rows' steps have set and
    whose done flag is set: the lane is the request's validity then False,
    done is its first token == eos, the other slot is untouched, and the
    slot's base position is its last position minus the global step."""
    import torch

    from glimpseprune_torch.serving import ContinuousBatcher

    s = make_setup()
    jr, tr = _runners(s)
    _, tp, r = _prefills(jr, tr, s)
    logits, valid, pos, kv_k, kv_v = tp()
    first = int(logits[0, -1].argmax())
    for eos, done in ((-1, False), (first, True)):
        b = ContinuousBatcher(tr, capacity=2, prefix_len=r, max_new_tokens=4, inter_steps=2,
                              eos=eos, max_requests=2)
        st = b.state
        with torch.inference_mode():
            b._begin()
            st.kv_valid.fill_(True)
            st.done.fill_(not done)
            st.admit(1, kv_k, kv_v, valid, logits, pos, 6)
        want = torch.zeros(b.T, dtype=torch.bool)
        want[:r] = valid[0]
        assert torch.equal(st.kv_valid[1], want) and st.kv_valid[0].all()
        assert bool(st.done[1]) is done and bool(st.done[0]) is (not done)
        assert int(st.tok[1]) == first
        assert torch.equal(st.last_pos[:, 1], pos[:, 0, -1] - 6)
        assert torch.equal(st.k_cache[:, 1, :r], kv_k[:, 0])
        assert not st.k_cache[:, 1, r:].any()


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_admission_fills_the_cache_tier(tier):
    """Under the int8 KV tier admission quantizes the request's raw kv as
    the runner's decode cache holds it; in both tiers the batcher's tokens
    are the pruned generate's row 0."""
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.ops import kv_cache
    from glimpseprune_torch.serving import ContinuousBatcher

    s = make_setup()
    cfg = dataclasses.replace(s.cfg, text=dataclasses.replace(s.cfg.text,
                                                              kv_cache_quant=tier))
    tr = GlimpsePruneRunner(cfg, s.tmodel)
    pre = tr.prefill(s.prep_t)
    row = _one_row(pre)
    r = int(row[1].shape[1])
    b = ContinuousBatcher(tr, capacity=2, prefix_len=r, max_new_tokens=5, inter_steps=5,
                          eos=-1, max_requests=2)
    seqs, _, _, _ = b.serve([lambda: row] * 2)
    want = tr.decode_cache(row[3], b.T)
    got = b.state.k_cache
    if tier == "int8":
        for k in ("q", "s"):
            assert kv_cache.is_quantized(got)
            assert (got[k][:, 0, :r] == want[k][:, 0, :r]).all()
    expect = tr.generate(s.prep_t, max_new_tokens=5).sequences[0]
    for i in range(2):
        np.testing.assert_array_equal(seqs[i], expect)


def test_card_path_captures_one_step_per_batcher(monkeypatch):
    """With torch.cuda's graph API faked and the runner's device said to be
    a card: the batcher's first serve captures its step once (over its own
    state, begun at slot R), a second serve captures nothing, and every
    decode step of both is a replay."""
    import torch

    from glimpseprune_torch import serving
    from test_torch_decode import _FakeCuda

    s = make_setup()
    jr, tr = _runners(s)
    _, tp, r = _prefills(jr, tr, s)
    row = tp()
    b = serving.ContinuousBatcher(tr, capacity=2, prefix_len=r, max_new_tokens=4,
                                  inter_steps=2, eos=-1, max_requests=2)
    fake = _FakeCuda()
    fake.install(monkeypatch)
    graphs = []
    step_graph = serving.StepGraph

    def recording(*args):
        graphs.append(step_graph(*args))
        assert int(b.state.write_start) == r
        return graphs[-1]

    monkeypatch.setattr(serving, "StepGraph", recording)
    monkeypatch.setattr(tr, "device", SimpleNamespace(type="cuda"))  # capture, faked
    for n in (1, 2):
        b.serve([lambda: row] * 2, rng=torch.Generator())
        assert len(graphs) == 1
        # 2 admissions' chunks and `need` drain chunks of 2 steps, per serve
        assert fake.replays == n * 2 * (2 + b.need - 1)

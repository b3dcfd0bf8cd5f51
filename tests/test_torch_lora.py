"""The port's in-layer LoRA (models/layers.py, training/lora.py) against the
JAX package's on the shared tiny weights (fp32):

- ``make_lora_params`` draws the JAX package's adapters from one seed, over
  the unquantized, int8 and int4 bases;
- the weight bridge carries JAX ``insert_lora`` params (``params_from_jax``)
  and bare adapter trees (``insert_lora``) to the port's adapters;
- ``insert_lora`` (the product inside each layer) against ``apply_lora``
  (the merged weights), in the port and against the JAX runner;
- LoRA ``generate`` in the unquantized, (q8) and (q4) tiers against the JAX
  runner over ``insert_lora`` params (A8 off on adapted layers in both);
- adapters on the q projections alone (a narrower ``targets``): only those
  are adapted, the rest keep W8A8, each projection against JAX's
  ``_dense`` in (q8);
- zero-B adapters and ``lora_disabled`` give the base model; the decode
  graph key holds the adapter state and addresses;
- ``save_lora`` / ``load_lora`` round trip.

Tolerances: greedy tokens and keep sets identical; logits within 1e-4 of
max |JAX| (fp32 sums in another order; LOGIT_RTOL of the quantized
tiers' parity tests where int8 rounding ties can move them)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu import quantization as jq
from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from glimpseprune_tpu.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
from glimpseprune_tpu.training import lora as jax_lora
from test_torch_delayed import assert_close
from test_torch_inputs import make_setup
from test_torch_quant_runner import LOGIT_RTOL, _tier
from test_torch_quant_runner import flash_interpret  # noqa: F401 (fixture)

RANK = 3


def with_rank(cfg, rank=RANK):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, lora_rank=rank))


def nonzero(lora):
    """Adapters that change the outputs (JAX test_grpo's +0.01 on A and B)."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.01, lora)


def port_tree(tree):
    import torch

    return {p: {k: torch.as_tensor(np.asarray(v)) for k, v in ab.items()}
            for p, ab in tree.items()}


@pytest.mark.parametrize("tier", ["none", "q8", "q4"])
def test_make_lora_params_draws_as_jax(tier):
    from glimpseprune_torch.training.lora import lora_param_count, make_lora_params

    s = make_setup()
    if tier == "none":
        jparams, model = s.params, s.tmodel
    else:
        _, _, jparams, _, model = _tier(tier)
    want = jax_lora.make_lora_params(jparams, rank=4, seed=3)
    got = make_lora_params(model, rank=4, seed=3)
    assert list(got) == list(want)
    assert len(got) == (0 if tier == "q4" else 7)  # int4 kernels are no targets
    for path in want:
        for k in ("a", "b"):
            np.testing.assert_array_equal(got[path][k].numpy(), np.asarray(want[path][k]))
    assert lora_param_count(got) == jax_lora.lora_param_count(want)


def test_weight_bridge_carries_jax_adapters():
    import torch

    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.training.lora import insert_lora, lora_tree

    s = make_setup()
    lora = nonzero(jax_lora.make_lora_params(s.params, rank=RANK, seed=1))
    model = load_from_jax(jax_lora.insert_lora(s.params, lora), with_rank(s.cfg),
                          device="cpu")
    inserted = insert_lora(copy.deepcopy(s.tmodel), port_tree(lora))
    assert inserted.cfg.text.lora_rank == RANK
    for path, ab in lora_tree(model).items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(ab[k].numpy(), np.asarray(lora[path][k]))
            np.testing.assert_array_equal(lora_tree(inserted)[path][k].numpy(),
                                          np.asarray(lora[path][k]))
    q = model.text.layers[1].self_attn.q_proj
    assert q.lora_a.dtype == torch.float32 and q.lora_a.shape == (s.cfg.text.hidden_size, RANK)
    np.testing.assert_array_equal(
        q.lora_b.detach().numpy(),
        np.asarray(lora["text/layers/self_attn/q_proj/kernel"]["b"])[1])


def test_insert_lora_matches_apply_lora_and_jax():
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.training.lora import apply_lora, insert_lora

    s = make_setup()
    lora = nonzero(jax_lora.make_lora_params(s.params, rank=RANK, seed=1))
    merged = GlimpsePruneRunner(s.cfg, apply_lora(s.tmodel, port_tree(lora))).glimpse(s.prep_t)
    model = insert_lora(copy.deepcopy(s.tmodel), port_tree(lora))
    inserted = GlimpsePruneRunner(with_rank(s.cfg), model).glimpse(s.prep_t)
    want = jax_runner.GlimpsePruneRunner(
        with_rank(s.cfg), jax_lora.insert_lora(s.params, lora),
        model=Qwen2_5_VL_GP(with_rank(s.cfg))).glimpse(s.prep_j)
    np.testing.assert_array_equal(inserted.keep_img.numpy(), merged.keep_img.numpy())
    np.testing.assert_array_equal(inserted.keep_img.numpy(), np.asarray(want.keep_img))
    assert_close(inserted.logits.numpy(), merged.logits.numpy())
    assert_close(inserted.logits.numpy(), np.asarray(want.logits))
    base = GlimpsePruneRunner(s.cfg, s.tmodel).glimpse(s.prep_t)
    assert not np.allclose(inserted.logits.numpy(), base.logits.numpy(), atol=1e-3)


def _lora_tiers(tier):
    """(JAX config, JAX params with adapters, port config, port model with
    the same adapters, setup) of a tier."""
    from glimpseprune_torch.training.lora import insert_lora

    s = make_setup()
    lora = nonzero(jax_lora.make_lora_params(s.params, rank=RANK, seed=1))
    if tier == "none":
        jcfg, tcfg, model = s.cfg, s.cfg, copy.deepcopy(s.tmodel)
        jparams = jax_lora.insert_lora(s.params, lora)
    else:
        _, jcfg, qparams, tcfg, model = _tier(tier)
        # an int8 base takes its adapters at kernel_q; an int4 base is built
        # from the adapted float tree (JAX insert_lora skips kernel_q4)
        jparams = (jax_lora.insert_lora(qparams, lora) if tier == "q8" else
                   jq.quantize_int4(jax_lora.insert_lora(s.params, lora)))
    insert_lora(model, port_tree(lora))
    return with_rank(jcfg), jparams, with_rank(tcfg), model, s


@pytest.mark.parametrize("tier", ["none", "q8", "q4"])
def test_lora_generate_matches_jax(tier, request):
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    if tier != "none":
        request.getfixturevalue("flash_interpret")
    jcfg, jparams, tcfg, model, s = _lora_tiers(tier)
    jr = jax_runner.GlimpsePruneRunner(jcfg, jparams, model=Qwen2_5_VL_GP(jcfg))
    tr = GlimpsePruneRunner(tcfg, model)
    want = jr.generate(s.prep_j, max_new_tokens=8)
    got = tr.generate(s.prep_t, max_new_tokens=8)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.keep_img, np.asarray(want.keep_img))
    w = np.asarray(jr.glimpse(s.prep_j).logits)
    assert_close(tr.glimpse(s.prep_t).logits.numpy(), w,
                 rtol=1e-4 if tier == "none" else LOGIT_RTOL)


def test_q_proj_only_adapters_match_jax_dense():
    """A tree over the q projections alone (q8 base): the port adapts those
    projections only, and each projection computes what JAX's ``_dense``
    computes on the leaves it would hold: the adapted one without A8 plus
    its adapter, the others W8A8. (The JAX runner itself refuses such a
    tree: a rank > 0 model declares adapter slots on all seven projections,
    and flax holds the params to that structure.)"""
    import torch

    from glimpseprune_tpu.models.qwen2_5_vl.language import _dense
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.training.lora import insert_lora, lora_tree, make_lora_params

    targets = r"text/layers/self_attn/q_proj/kernel(_q)?"
    s, _, qparams, tcfg, model = _tier("q8")
    lora = nonzero(jax_lora.make_lora_params(qparams, rank=RANK, targets=targets, seed=1))
    got_tree = make_lora_params(model, rank=RANK, targets=targets, seed=1)
    assert list(got_tree) == list(lora) == ["text/layers/self_attn/q_proj/kernel"]
    insert_lora(model, port_tree(lora))
    assert list(lora_tree(model)) == list(lora)
    x = np.random.default_rng(0).normal(size=(5, tcfg.text.hidden_size)).astype(np.float32)
    jlayers = qparams["text"]["layers"]
    for l, layer in enumerate(model.text.layers):
        for name, mod in (("self_attn/q_proj", layer.self_attn.q_proj),
                          ("self_attn/k_proj", layer.self_attn.k_proj),
                          ("mlp/down_proj", layer.mlp.down_proj)):
            assert mod.lora_active() == (name == "self_attn/q_proj")
            part, proj = name.split("/")
            p = {k: np.asarray(v)[l] for k, v in jlayers[part][proj].items()}
            if mod.lora_active():
                ab = lora[f"text/layers/{name}/kernel"]
                p.update(lora_a=np.asarray(ab["a"])[l], lora_b=np.asarray(ab["b"])[l])
            xin = x if name != "mlp/down_proj" else np.random.default_rng(l).normal(
                size=(5, mod.in_features)).astype(np.float32)
            want = np.asarray(_dense(jnp.asarray(xin), p, jnp.float32, a8=True))
            got = mod(torch.from_numpy(xin), a8=True).detach().numpy()
            assert_close(got, want, rtol=1e-6)
    out = GlimpsePruneRunner(with_rank(tcfg), model).generate(s.prep_t, max_new_tokens=4)
    assert np.isfinite(out.mask_logits).all()


def test_zero_b_and_disabled_adapters_give_the_base():
    from glimpseprune_torch.models.layers import lora_disabled, lora_state
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.training.lora import insert_lora, make_lora_params

    s = make_setup()
    base = GlimpsePruneRunner(s.cfg, s.tmodel).generate(s.prep_t, max_new_tokens=8)
    model = copy.deepcopy(s.tmodel)
    zero_b = make_lora_params(model, rank=RANK, seed=2)
    tr = GlimpsePruneRunner(with_rank(s.cfg), insert_lora(model, zero_b))
    np.testing.assert_array_equal(tr.generate(s.prep_t, max_new_tokens=8).sequences,
                                  base.sequences)
    insert_lora(model, port_tree(nonzero(zero_b)))
    assert lora_state(model.text)[:2] == (RANK, True)
    adapted = tr.generate(s.prep_t, max_new_tokens=8)
    with lora_disabled(model):
        assert lora_state(model.text)[:2] == (RANK, False)
        off = tr.generate(s.prep_t, max_new_tokens=8)
    assert lora_state(model.text)[:2] == (RANK, True)
    np.testing.assert_array_equal(off.sequences, base.sequences)
    np.testing.assert_array_equal(off.mask_logits, base.mask_logits)
    assert not np.allclose(adapted.mask_logits, base.mask_logits, atol=1e-3)
    # the base runner refuses the model once it is bound to the adapted config
    with pytest.raises(ValueError, match="lora_rank"):
        GlimpsePruneRunner(s.cfg, model)


def test_decode_graph_key_holds_the_adapter_state(monkeypatch):
    """A step captured with the adapters on is not replayed under
    lora_disabled, nor the reverse: each state has its own graph. An update
    of the adapters in place replays the same graph; adapters removed and
    put in anew at the same rank, at other addresses, are captured again."""
    from types import SimpleNamespace

    import torch

    from glimpseprune_torch.models.layers import lora_disabled
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.ops import kv_cache
    from glimpseprune_torch.training.lora import (insert_lora, lora_parameters,
                                                  make_lora_params, remove_lora)
    from test_torch_decode import _FakeCuda

    _FakeCuda().install(monkeypatch)
    s = make_setup()
    model = insert_lora(copy.deepcopy(s.tmodel), make_lora_params(s.tmodel, rank=RANK))
    tr = GlimpsePruneRunner(with_rank(s.cfg), model)
    pre = tr.prefill(s.prep_t)
    r, n = pre.valid.shape[1], 4
    shape = pre.kv_k.shape[:2] + (r + n,) + pre.kv_k.shape[3:]
    caches = [kv_cache.alloc_cache(shape, pre.kv_k.dtype, "cpu", "none") for _ in range(2)]
    for c, kv in zip(caches, (pre.kv_k, pre.kv_v)):
        kv_cache.cache_set_prefix(c, kv)
    monkeypatch.setattr(tr, "device", SimpleNamespace(type="cuda"))  # capture, faked

    def decode():
        tr._decode_loop(pre.logits, pre.valid, pre.position_ids, *caches, n, -1,
                        chunk_size=n, prealloc_t=r + n)

    decode()
    decode()
    assert len(tr.decode_graphs._graphs) == 1
    with lora_disabled(model):
        decode()
    keys = list(tr.decode_graphs._graphs)
    assert len(keys) == 2 and {k[-1][:2] for k in keys} == {(RANK, True), (RANK, False)}
    with torch.no_grad():  # the optimizer's update: in place
        for p in lora_parameters(model).values():
            p.add_(0.01)
    decode()
    assert set(tr.decode_graphs._graphs) == set(keys)
    # the old adapters are held, so that the new ones cannot take their
    # addresses: a graph that reads the old addresses must not be replayed
    old = list(lora_parameters(model).values())
    remove_lora(model)
    insert_lora(model, make_lora_params(s.tmodel, rank=RANK, seed=5))
    decode()
    new = list(tr.decode_graphs._graphs)
    assert len(new) == 3 and new[-1] not in keys and new[-1][-1][:2] == (RANK, True)
    assert len(old) == len(new[-1][-1][2])


def test_save_load_lora_round_trip(tmp_path):
    from glimpseprune_torch.persistence import load_lora, save_lora
    from glimpseprune_torch.training.lora import insert_lora, lora_tree, make_lora_params

    s = make_setup()
    lora = port_tree(nonzero(make_lora_params(s.tmodel, rank=RANK, seed=4)))
    save_lora(lora, str(tmp_path))
    back = load_lora(str(tmp_path))
    assert list(back) == list(lora)
    model = insert_lora(copy.deepcopy(s.tmodel), back)
    for path, ab in lora_tree(model).items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(ab[k].numpy(), lora[path][k].numpy())


def test_batcher_refuses_another_adapter_state(monkeypatch):
    """A continuous batcher's captured step bakes in the adapters' state:
    a call under lora_disabled after the capture raises."""
    from types import SimpleNamespace

    import torch

    from glimpseprune_torch.models.layers import lora_disabled
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.serving import ContinuousBatcher
    from glimpseprune_torch.training.lora import insert_lora, make_lora_params
    from test_torch_decode import _FakeCuda

    s = make_setup()
    model = insert_lora(copy.deepcopy(s.tmodel), make_lora_params(s.tmodel, rank=RANK))
    tr = GlimpsePruneRunner(with_rank(s.cfg), model)
    b = ContinuousBatcher(tr, capacity=2, prefix_len=8, max_new_tokens=4, inter_steps=2,
                          eos=-1, max_requests=2)
    _FakeCuda().install(monkeypatch)
    monkeypatch.setattr(tr, "device", SimpleNamespace(type="cuda"))  # capture, faked
    with torch.inference_mode():  # the batcher's state is made of inference tensors
        steps = b._decode_steps()
        assert b._decode_steps() is steps
        with lora_disabled(model), pytest.raises(ValueError, match="LoRA"):
            b._decode_steps()

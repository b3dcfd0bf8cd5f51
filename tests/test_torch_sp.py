"""Sequence parallelism in the port (glimpseprune_torch/parallel/) on gloo
process groups of 2 and 4 CPU ranks, started by the port's launcher: the
three collectives forward and backward against their unsharded meaning,
each SP attention entry point against the unsharded port, SP ``generate``
(pruned and unpruned) against the JAX runner on one device, one SP train
step (loss, every trainable gradient, the AdamW update) against the JAX
``make_train_step``, a runner built outside the SP context and run inside
it, and the compressors refusing SP.

The ranks run tests/torch_sp_worker.py, which imports torch and the port
only; the weights reach them as an ``.npz`` of ``params_from_jax``. Each
world size is one launch whose results every test of that size reads. The
tiny config's sequence (S = 24, seq_multiple 8) and packed patches (P = 64,
patch_multiple 64: whole windows of 16) divide over both world sizes, so
the ViT, the prefill layers and the resume layers all run sharded."""

import functools

import jax
import numpy as np
import optax
import pytest

import torch_sp_worker
from glimpseprune_tpu.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
from glimpseprune_tpu.models.qwen2_5_vl.runner import GlimpsePruneRunner as JaxRunner
from glimpseprune_tpu.models.qwen2_5_vl.runner import prepare_inputs as jax_prepare_inputs
from glimpseprune_tpu.training.train_step import init_train_state, make_train_step
from test_torch_inputs import make_batch_args
from test_torch_training import LOSS_TOL, METRIC_KEYS, jax_batch, torch_names, train_setup

WORLDS = (2, 4)
PATCH_MULTIPLE = 64
LR = 1e-3
# the SP attention entry points against the unsharded port: the same fp32
# plain versions over fewer query rows, sums in another order
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)


def _args(with_answers):
    cfg = train_setup()[0]
    prompts, images, kwargs = make_batch_args(cfg, 0, with_answers=with_answers)
    return prompts, images, dict(kwargs, patch_multiple=PATCH_MULTIPLE)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from glimpseprune_torch.convert import params_from_jax

    cfg, _, _, _, params = train_setup()
    path = tmp_path_factory.mktemp("sp") / "weights.npz"
    np.savez(path, **{k: v.numpy() for k, v in params_from_jax(params, cfg).items()})
    return str(path)


_RESULTS = {}


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, weights):
    """Every rank's results of one launch at this world size."""
    from glimpseprune_torch.parallel import launch

    world = request.param
    if world not in _RESULTS:
        _RESULTS[world] = launch(torch_sp_worker.run, world, weights, _args(False),
                                 _args(True), backend="gloo", timeout_s=300)
    return _RESULTS[world]


@functools.lru_cache(maxsize=None)
def jax_generate(do_selection):
    cfg, _, _, _, params = train_setup()
    prep = jax_prepare_inputs(cfg, *_args(False)[:2], **_args(False)[2])
    res = JaxRunner(cfg, params).generate(prep, max_new_tokens=4, do_selection=do_selection)
    return res, prep.img_valid


def _capture():
    """An optax transformation that keeps the gradient it is given in its
    state and passes it on unchanged."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(np.zeros_like, p), lambda g, s, p=None: (g, g))


@functools.lru_cache(maxsize=None)
def jax_train_step():
    """One JAX train step with clip 1.0 + AdamW -> (metrics, {port name:
    gradient}, {port name: updated weight})."""
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs

    cfg, _, _, _, params = train_setup()
    opt = optax.chain(_capture(), optax.clip_by_global_norm(1.0),
                      optax.adamw(LR, weight_decay=0.01))
    state, frozen = init_train_state(params, opt)
    step = jax.jit(make_train_step(cfg, Qwen2_5_VL_GP(cfg), opt))
    prep = prepare_inputs(cfg, *_args(True)[:2], **_args(True)[2])
    state, metrics = step(state, frozen, jax_batch(prep), jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in metrics.items()}, torch_names(state.opt_state[0]),
            torch_names(state.trainable))


def test_sp_state_and_sharded_sites(ranks):
    """SP is off outside the context and restored after it, and every call
    site of the tiny config shards at this world size."""
    for r in ranks:
        assert r["sp_off"] and r["sp_restored"]
        assert r["sharded_sites"] == {"vit": True, "llm": True, "resume": True}


def test_sp_collectives_forward_and_backward(ranks):
    world = len(ranks)
    rng = np.random.default_rng(5)
    x, w = (rng.standard_normal((2, 4 * world, 3)) for _ in range(2))
    for rank, r in enumerate(ranks):
        c = r["collectives"]
        rows = slice(rank * 4, (rank + 1) * 4)
        np.testing.assert_array_equal(c["split"], x[:, rows])
        np.testing.assert_array_equal(c["split_grad"], w)  # the whole gradient on every rank
        np.testing.assert_array_equal(c["gather"], x)
        np.testing.assert_array_equal(c["gather_grad"], w[:, rows])  # no sum
        np.testing.assert_array_equal(c["gather_kv"], x)
        # the sum of every rank's gradient of its use, sliced to this rank
        np.testing.assert_allclose(c["gather_kv_grad"],
                                   w[:, rows] * sum(range(1, world + 1)), rtol=1e-15)


@pytest.mark.parametrize("kind", ["segment", "segment_dense", "window", "fused_window",
                                  "causal"])
def test_sp_attention_matches_unsharded(ranks, kind):
    for r in ranks:
        got, want, valid = r["attention"][kind]
        np.testing.assert_allclose(got[valid], want[valid], **ATTN_TOL)


@pytest.mark.parametrize("do_selection", [True, False], ids=["pruned", "unpruned"])
def test_sp_generate_matches_jax(ranks, do_selection):
    """Greedy tokens equal to the JAX runner's on one device, mask logits
    of the image tokens within 1e-4 (tests/test_sp.py:166-168), on every
    rank. The ViT's full-attention block ran on a shard both times. The
    pruned prefill ran K9 in every layer (2 before the keep policy over
    S = 24 slots, 2 resume layers over 16); the unpruned prefill drops the
    trailing glimpse slot (S = 23, as the JAX runner does), which divides
    over no world size, so its layers ran unsharded by the per-call-site
    rule."""
    want, img_valid = jax_generate(do_selection)
    for r in ranks:
        got = r["generate"][do_selection]
        np.testing.assert_array_equal(got["sequences"], want.sequences)
        np.testing.assert_array_equal(got["num_generated"], want.num_generated)
        assert got["k9_calls"] == (4 if do_selection else 0)
        assert got["segment_shard_calls"] == 1
        if do_selection:
            np.testing.assert_array_equal(got["keep_img"], want.keep_img)
            np.testing.assert_allclose(got["mask_logits"][:, img_valid],
                                       want.mask_logits[:, img_valid], rtol=1e-4, atol=1e-4)


def test_sp_runner_built_outside_context(ranks):
    """The runner was built before sequence_parallel and sharded inside it
    (the generate test's calls), and the same runner runs unsharded after
    it, with the same tokens."""
    for r in ranks:
        assert r["generate"][True]["k9_calls"] > 0
        np.testing.assert_array_equal(r["generate"]["unsharded"],
                                      r["generate"][True]["sequences"])


def test_sp_compressors_refuse(ranks):
    for r in ranks:
        assert "not sequence-parallel" in r["generate"]["compressed_refused"]


def test_sp_train_step_loss_matches_jax(ranks):
    want, _, _ = jax_train_step()
    for r in ranks:
        for key in METRIC_KEYS:
            np.testing.assert_allclose(r["train"]["metrics"][key], want[key], **LOSS_TOL,
                                       err_msg=key)


def test_sp_train_step_grads_match_jax(ranks):
    """Every trainable gradient, whole on every rank, against jax.grad on
    one device, at test_torch_training's tolerance."""
    _, want, _ = jax_train_step()
    for r in ranks:
        got = r["train"]["grads"]
        assert set(got) == set(want)
        for name in sorted(want):
            w = want[name]
            np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)


def test_sp_train_step_update_matches_jax(ranks):
    """The weights after one AdamW step, on every rank, against the JAX
    TrainState, at test_torch_training's tolerance for one step."""
    _, grads, want = jax_train_step()
    start = torch_names({})
    for r in ranks:
        for name, p in r["train"]["params"].items():
            assert np.abs(want[name] - start[name]).max() > 0, name
            g = np.abs(grads[name])
            tol = 1e-6 + LR * np.minimum(1.0, 1e-4 * g.max() / np.maximum(g, 1e-30))
            assert (np.abs(p - want[name]) <= tol).all(), name

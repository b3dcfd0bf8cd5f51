"""The port's base training step (glimpseprune_torch/training/,
``glimpse_encode(labels, training=True)``, ``TextDecoder.chunked_nll``, the
fuser's training outputs) against the JAX package's on the same tiny
weights and batch: losses and metrics, every trainable gradient, remat,
the optimizer (optax's AdamW with global-norm clipping) and the trainable
parameters after three steps. fp32 on the CPU, where the flash attention
calls take their plain versions (forward with LSE, backward)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from glimpseprune_tpu.config import tiny_test_config
from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from glimpseprune_tpu.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
from glimpseprune_tpu.training.train_step import init_train_state, make_train_step
from glimpseprune_tpu.training.trainer import SCHEDULERS as JAX_SCHEDULERS
from test_torch_inputs import make_batch_args, random_params

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)  # fp32 scalars, sums in another order
METRIC_KEYS = ("loss", "loc_loss", "le_loss", "mask_iou", "mask_precision", "mask_recall")


@functools.lru_cache(maxsize=None)
def train_setup():
    """Tiny config, one training batch (answers and boxes) prepared by both
    packages, random JAX params."""
    from glimpseprune_torch.models.qwen2_5_vl import inputs as torch_inputs

    cfg = tiny_test_config()
    prompts, images, kwargs = make_batch_args(cfg, 0, with_answers=True)
    prep_j = jax_runner.prepare_inputs(cfg, prompts, images, **kwargs)
    prep_t = torch_inputs.prepare_inputs(cfg, prompts, images, **kwargs)
    jmodel = Qwen2_5_VL_GP(cfg)
    return cfg, prep_j, prep_t, jmodel, random_params(jmodel, prep_j, 0)


def jax_batch(prep):
    from glimpseprune_torch.training.trainer import batch_from_prep

    return {k: jnp.asarray(v.numpy()) for k, v in batch_from_prep(prep, "cpu").items()}


def torch_model(cfg, params, remat=False):
    """A fresh port model on the CPU in fp32 (training changes it in place)."""
    from glimpseprune_torch.convert import load_from_jax

    model = load_from_jax(params, cfg, device="cpu")
    if remat:
        model.cfg = cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                                           remat=True))
        model.text.cfg = cfg.text
    return model


def capture_grads():
    """An optax transformation whose state after one update is the
    gradient it was given, and whose update is zero."""
    zeros = functools.partial(jax.tree_util.tree_map, jnp.zeros_like)
    return optax.GradientTransformation(lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


def jax_step(opt, n_steps=1, cfg=None):
    """n JAX train steps -> (state, metrics of each step)."""
    cfg0, prep_j, _, jmodel, params = train_setup()
    cfg = cfg or cfg0
    state, frozen = init_train_state(params, opt)
    step = jax.jit(make_train_step(cfg, Qwen2_5_VL_GP(cfg), opt))
    batch = jax_batch(prep_j)
    metrics = []
    for i in range(n_steps):
        state, m = step(state, frozen, batch, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def torch_names(tree):
    """A JAX trainable subtree -> {port parameter name: numpy array}."""
    from glimpseprune_torch.convert import params_from_jax
    from glimpseprune_torch.training.train_step import new_module_filter

    cfg, _, _, _, params = train_setup()
    state = params_from_jax({**params, **tree}, cfg)
    return {k: v.numpy() for k, v in state.items() if new_module_filter(k)}


def torch_grads(remat=False):
    """One port forward + backward -> (metrics, {name: grad})."""
    from glimpseprune_torch.training.train_step import compute_loss, init_trainable
    from glimpseprune_torch.training.trainer import batch_from_prep

    cfg, _, prep_t, _, params = train_setup()
    model = torch_model(cfg, params, remat)
    trainable = init_trainable(model)
    total, metrics = compute_loss(model.cfg, model, batch_from_prep(prep_t, "cpu"))
    total.backward()
    frozen_grads = [n for n, p in model.named_parameters() if n not in trainable
                    and p.grad is not None]
    assert frozen_grads == []
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.numpy().copy() for k, p in trainable.items()})


def test_chunked_nll_matches_jax_and_full_ce():
    """chunked_nll (checkpointed chunks of C positions) equals the JAX one
    and the full [B, S, V] log-softmax CE, in value and in the gradient
    w.r.t. the hidden states; chunk 7 leaves a ragged tail."""
    import torch

    cfg, prep_j, _, jmodel, params = train_setup()
    model = torch_model(cfg, params)
    rng = np.random.default_rng(3)
    b, s = prep_j.input_ids.shape
    x = rng.standard_normal((b, s, cfg.text.hidden_size)).astype(np.float32)
    labels = np.full((b, s), -100, np.int64)
    labels[0, 5:s - 2] = rng.integers(0, cfg.text.vocab_size, s - 7)
    labels[1, 3:9] = rng.integers(0, cfg.text.vocab_size, 6)

    def full_ce(xx):
        lg = model.text.logits(model.text.final_norm(xx)).float()[:, :-1]
        y = torch.as_tensor(labels[:, 1:])
        return torch.nn.functional.cross_entropy(lg.reshape(-1, lg.shape[-1]), y.reshape(-1),
                                                 ignore_index=-100)

    xt = torch.as_tensor(x).requires_grad_(True)
    want = full_ce(xt)
    (gw,) = torch.autograd.grad(want, xt)
    for chunk in (4, 7, 512):
        xt = torch.as_tensor(x).requires_grad_(True)
        got = model.text.chunked_nll(model.text.final_norm(xt), torch.as_tensor(labels),
                                     chunk=chunk)
        (gc,) = torch.autograd.grad(got, xt)
        want_j = jmodel.apply({"params": params}, jnp.asarray(x), method=lambda m, h: (
            m.text.chunked_nll(m.text.final_norm(h), jnp.asarray(labels, jnp.int32),
                               chunk=chunk)))
        np.testing.assert_allclose(got.item(), want.item(), rtol=2e-5)
        np.testing.assert_allclose(got.item(), float(want_j), rtol=2e-5)
        np.testing.assert_allclose(gc.numpy(), gw.numpy(), atol=2e-6)


def test_glimpse_encode_training_outputs_match_jax():
    """Training outputs: every fuser layer's mask logits (deep supervision,
    no normalized raw-attention row) and the answer loss after all layers."""
    import torch

    from glimpseprune_torch.training.trainer import batch_from_prep

    cfg, prep_j, prep_t, jmodel, params = train_setup()
    model = torch_model(cfg, params)
    keys = ("input_ids", "valid", "position_ids", "packed_idx", "img_slots", "img_valid",
            "fuser_window_index", "fuser_reverse_index", "fuser_segment_ids",
            "fuser_pos_ids", "le_start", "labels")
    jb = jax_batch(prep_j)

    def run(m):
        merged, taps = m.vision_encode(jb["patches"], jb["vis_pos_ids"], jb["full_seg"],
                                       jb["vis_valid"])
        logits, _, le = m.glimpse_encode(image_embeds=merged, taps=jnp.stack(taps),
                                         training=True, **{k: jb[k] for k in keys})
        return logits, le

    logits_j, le_j = jmodel.apply({"params": params}, method=run)
    tb = batch_from_prep(prep_t, "cpu")
    with torch.no_grad():
        merged, taps = model.vision_encode(tb["patches"], tb["vis_pos_ids"], tb["full_seg"],
                                           tb["vis_valid"])
        logits_t, _, le_t = model.glimpse_encode(image_embeds=merged, taps=taps,
                                                 training=True, **{k: tb[k] for k in keys})
    n_layers = len(cfg.gp.selected_visual_layers)
    assert logits_t.shape[0] == n_layers == logits_j.shape[0]
    img_valid = prep_j.img_valid
    np.testing.assert_allclose(logits_t.numpy()[:, img_valid],
                               np.asarray(logits_j)[:, img_valid], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(le_t), float(le_j), **LOSS_TOL)


def test_train_step_loss_and_metrics_match_jax():
    _, [want] = jax_step(capture_grads())
    got, _ = torch_grads()
    for key in METRIC_KEYS:
        np.testing.assert_allclose(got[key], want[key], **LOSS_TOL, err_msg=key)
    assert want["le_loss"] > 0 and want["loc_loss"] > 0


def test_trainable_grads_match_jax():
    """Every trainable gradient against jax.grad of the JAX loss, at rtol
    1e-4; atol 1e-4 of the tensor's largest gradient covers entries near 0,
    whose relative error is the fp32 sum's, not the entry's."""
    state, _ = jax_step(capture_grads())
    want = torch_names(state.opt_state)
    _, got = torch_grads()
    assert set(got) == set(want)
    for name in sorted(want):
        w = want[name]
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_remat_matches_no_remat():
    """cfg.text.remat (per-layer torch.utils.checkpoint) changes the
    backward's memory plan, not its values."""
    m0, g0 = torch_grads(remat=False)
    m1, g1 = torch_grads(remat=True)
    assert m0 == m1
    for name in g0:
        np.testing.assert_allclose(g1[name], g0[name], rtol=1e-6, atol=1e-9, err_msg=name)


def test_three_steps_match_jax_train_state():
    """Trainable parameters after three AdamW steps (clip 1.0, weight
    decay 0.01, lr 1e-3) against the JAX TrainState. Adam divides each
    entry's step by that entry's own gradient RMS, so the step of an entry
    with gradient g carries g's relative error, which is the fp32 noise of
    the sum (1e-4 of the tensor's largest gradient, as in
    test_trainable_grads_match_jax) over |g|, capped at 1: the tolerance is
    1e-6 + steps * lr * min(1, 1e-4 * max|g| / |g|)."""
    from glimpseprune_torch.training.train_step import AdamW, init_trainable, make_train_step
    from glimpseprune_torch.training.trainer import batch_from_prep

    cfg, _, prep_t, _, params = train_setup()
    lr, n_steps = 1e-3, 3
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, weight_decay=0.01))
    state, metrics_j = jax_step(opt, n_steps=n_steps)
    want = torch_names(state.trainable)
    first_grads = torch_names(jax_step(capture_grads())[0].opt_state)

    model = torch_model(cfg, params)
    adamw = AdamW(init_trainable(model), lr, weight_decay=0.01, max_grad_norm=1.0)
    step = make_train_step(cfg, model, adamw)
    batch = batch_from_prep(prep_t, "cpu")
    for i in range(n_steps):
        got = {k: float(v) for k, v in step(batch).items()}
        np.testing.assert_allclose(got["loss"], metrics_j[i]["loss"], rtol=1e-5)
    start = torch_names({})
    for name, p in adamw.params.items():
        assert np.abs(want[name] - start[name]).max() > 0, name
        g = np.abs(first_grads[name])
        tol = 1e-6 + n_steps * lr * np.minimum(1.0, 1e-4 * g.max() / np.maximum(g, 1e-30))
        diff = np.abs(p.detach().numpy() - want[name])
        assert (diff <= tol).all(), (name, float((diff - tol).max()))


def test_adamw_matches_optax():
    """The port's AdamW against optax.chain(clip_by_global_norm, adamw) on
    fixed gradients: five steps, one of them clipped, with weight decay and
    a schedule."""
    import torch

    from glimpseprune_torch.training.train_step import AdamW

    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * (3.0 if i == 2 else 0.2)).astype(np.float32)
              for k, v in p0.items()} for i in range(5)]
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=0.05))
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    st = opt.init(pj)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in p0.items()}
    adamw = AdamW(tp, lambda c: float(sched(c)), weight_decay=0.05, max_grad_norm=1.0)
    for g in grads:
        upd, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k])
        adamw.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(pj[k]), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("name,warmup", [
    ("constant", 0), ("constant", 3), ("linear", 0), ("linear", 3), ("cosine", 0),
    ("cosine", 3), ("exponential", 0),  # the exponential schedule takes no warmup
])
def test_schedules_match_optax(name, warmup):
    from glimpseprune_torch.training.trainer import SCHEDULERS

    total, lr = 12, 2e-3
    want = JAX_SCHEDULERS.get(name)(lr, total, warmup)
    got = SCHEDULERS.get(name)(lr, total, warmup)
    for count in range(total + 3):
        w = want(count) if callable(want) else want
        # optax evaluates in fp32, whose 1 + cos(x) near the cosine's end
        # keeps ~1e-6 of the peak: atol 1e-6 * lr
        np.testing.assert_allclose(got(count), float(w), rtol=1e-6, atol=1e-6 * lr,
                                   err_msg=f"{name} step {count}")


def test_le_dropout_draws_from_the_step_generator():
    """With le_dropout_prob > 0 the glimpse-embedding dropout mask comes
    from the generator: the same seed gives the same loss, another seed
    another loss, and both differ from the loss without dropout."""
    import torch

    from glimpseprune_torch.training.train_step import compute_loss
    from glimpseprune_torch.training.trainer import batch_from_prep, step_generator

    cfg, _, prep_t, _, params = train_setup()
    cfg = dataclasses.replace(cfg, gp=dataclasses.replace(cfg.gp, le_dropout_prob=0.5))
    model = torch_model(cfg, params)
    batch = batch_from_prep(prep_t, "cpu")
    with torch.no_grad():
        loss = [float(compute_loss(cfg, model, batch, step_generator(0, s, "cpu"))[0])
                for s in (0, 0, 1)]
        plain = float(compute_loss(cfg, torch_model(train_setup()[0], params), batch)[0])
    assert loss[0] == loss[1] and loss[0] != loss[2]
    assert plain not in loss

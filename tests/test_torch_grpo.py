"""The port's GlimpsePrune+ stage (training/grpo.py, the teacher-forcing
forwards, training/data.py's sampler) against the JAX package's on the
shared tiny weights (fp32):

- the score functions, the whitening, the surrogate, the k3 KL and
  ``token_logprobs`` on the same inputs; ``RepeatRandomSampler``'s order;
- ``completion_logprobs`` (and ``completion_logits``) against JAX;
- one ``make_grpo_loss_step`` on a fixed ``GRPOBatch`` with non-zero B and
  advantages: the losses, every adapter's gradient and the AdamW update
  against ``jax.grad`` and JAX's optax ``adamw`` step;
- ``GRPOTrainer``'s mask mixing draws the JAX trainer's rows from the same
  host RNG; a whole step runs, moves the adapters in place (a captured
  decode step keeps reading them) and leaves every base weight as it was.

Sampling differs between the packages (jax.random against a
torch.Generator), so the step's parity uses a fixed batch. Tolerances:
keep sets and token orders identical; logprobs, losses, gradients and
updates within 1e-4 of max |JAX|."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from glimpseprune_tpu.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
from glimpseprune_tpu.models.qwen2_5_vl.runner import GlimpsePruneRunner as JaxRunner
from glimpseprune_tpu.training import data as jax_data
from glimpseprune_tpu.training import grpo as jax_grpo
from glimpseprune_tpu.training import lora as jax_lora
from test_torch_delayed import assert_close
from test_torch_inputs import make_setup

RANK = 2


class Judge:
    """A stand-in judge: scores a completion by its length."""

    def score(self, queries, completions, answers):
        return [min(len(c) / 10.0, 1.0) for c in completions]


SCORE_CASES = [
    (["q"] * 4, ["yes", "B", "[0, 0, 50, 50]", " a "],
     ["yes", "The answer is B", "[0, 0, 50, 50]", "a"]),
    (["q"] * 3, ["no", "C", "[0.1, 0.2, 0.3, 0.4]"],
     ["[1,2,3,4] [5,6,7,8]", "(A)", "box [10, 20, 30, 40] here"]),
]


@pytest.mark.parametrize("case", range(len(SCORE_CASES)))
@pytest.mark.parametrize("name", ["precision_match", "single_choice", "one_box_iou",
                                  "one_box_format", "llm", "precision_match_or_llm",
                                  "dummy"])
def test_score_funcs_match_jax(name, case):
    from glimpseprune_torch.training.grpo import SCORE_FUNCS

    q, a, c = SCORE_CASES[case]
    got = SCORE_FUNCS.get(name)(q, a, c, client=Judge())
    want = jax_grpo.SCORE_FUNCS.get(name)(q, a, c, client=Judge())
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_offline_fallback_without_judge():
    from glimpseprune_torch.training.grpo import SCORE_FUNCS

    q, a, c = SCORE_CASES[0]
    assert SCORE_FUNCS.get("precision_match_or_llm")(q, a, c) == \
        jax_grpo.SCORE_FUNCS.get("precision_match_or_llm")(q, a, c) == [1.0, 0.0, 1.0, 1.0]
    with pytest.raises(ValueError, match="client"):
        SCORE_FUNCS.get("llm")(q, a, c)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_pieces_match_jax(seed):
    import torch

    from glimpseprune_torch.training import grpo

    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 3, 8).astype(np.float32) / 2
    logits = rng.normal(size=(4, 6, 11)).astype(np.float32)
    toks = rng.integers(0, 11, (4, 6))
    pol = rng.normal(size=(4, 6)).astype(np.float32) - 2
    ref = pol + 0.3 * rng.normal(size=(4, 6)).astype(np.float32)
    adv = rng.normal(size=4).astype(np.float32)
    mask = (np.arange(6)[None] < np.array([6, 3, 1, 0])[:, None]).astype(np.float32)
    t = torch.as_tensor
    assert_close(grpo.whiten_group_scores(t(scores), 4).numpy(),
                 jax_grpo.whiten_group_scores(jnp.asarray(scores), 4))
    assert_close(grpo.token_logprobs(t(logits), t(toks)).numpy(),
                 jax_grpo.token_logprobs(jnp.asarray(logits), jnp.asarray(toks)))
    assert_close(grpo.grpo_surrogate(t(pol), t(adv), t(mask)).numpy(),
                 jax_grpo.grpo_surrogate(jnp.asarray(pol), jnp.asarray(adv), jnp.asarray(mask)))
    assert_close(grpo.k3_kl(t(pol), t(ref), t(mask)).numpy(),
                 jax_grpo.k3_kl(jnp.asarray(pol), jnp.asarray(ref), jnp.asarray(mask)))


@pytest.mark.parametrize("n,g,seed", [(5, 2, 0), (7, 4, 3)])
def test_repeat_random_sampler_order_matches_jax(n, g, seed):
    from glimpseprune_torch.training.data import RepeatRandomSampler

    got = list(RepeatRandomSampler(n, g, seed))
    assert got == list(jax_data.RepeatRandomSampler(n, g, seed))
    assert len(got) == len(RepeatRandomSampler(n, g, seed)) == n * g


def fixed_batch(s, t=5):
    """A GRPOBatch on the tiny setup's pruned prompts (the JAX glimpse),
    with completions of 5 and 3 tokens and non-zero advantages, as numpy."""
    out = JaxRunner(s.cfg, s.params).glimpse(s.prep_j)
    rng = np.random.default_rng(7)
    b = out.valid.shape[0]
    last = np.asarray(out.position_ids)[:, :, -1]
    return dict(
        prompt_embeds=np.array(out.embeds), prompt_valid=np.array(out.valid),
        prompt_pos=np.array(out.position_ids),
        completion_ids=rng.integers(5, s.cfg.text.vocab_size, (b, t)).astype(np.int32),
        completion_valid=np.arange(t)[None] < np.array([t, 3])[:, None],
        completion_pos=(last[:, :, None] + 1 + np.arange(t)).astype(np.int32),
        advantages=np.array([0.8, -1.1], np.float32),
        ref_logps=np.zeros((b, t), np.float32))


def test_completion_logprobs_match_jax():
    import torch

    from glimpseprune_torch.training.grpo import token_logprobs

    s = make_setup()
    bt = fixed_batch(s)
    args = [bt[k] for k in ("prompt_embeds", "prompt_valid", "prompt_pos", "completion_ids",
                            "completion_valid", "completion_pos")]
    jm = s.jmodel
    want = jm.apply({"params": s.params}, *map(jnp.asarray, args),
                    method=jm.completion_logprobs)
    with torch.inference_mode():
        got = s.tmodel.completion_logprobs(*map(torch.as_tensor, args))
        full = s.tmodel.completion_logits(*map(torch.as_tensor, args))
    # a completion pad's hidden state differs by design (the flash kernel's
    # zero rows): compare the tokens that count
    m = bt["completion_valid"]
    assert_close(got.numpy(), np.asarray(want), m)
    r = bt["prompt_embeds"].shape[1]
    assert_close(got.numpy(),
                 token_logprobs(full[:, r - 1:-1], torch.as_tensor(bt["completion_ids"])).numpy())


def test_grpo_loss_step_matches_jax():
    """One step over the adapters: losses, gradients and the AdamW update."""
    import torch

    from glimpseprune_torch.training import grpo
    from glimpseprune_torch.training.lora import insert_lora, lora_parameters, lora_tree
    from glimpseprune_torch.training.train_step import AdamW

    s = make_setup()
    lr = 1e-3
    lora = jax.tree_util.tree_map(lambda x: x + 0.05,
                                  jax_lora.make_lora_params(s.params, rank=RANK, seed=1))
    pcfg = dataclasses.replace(s.cfg, text=dataclasses.replace(s.cfg.text, lora_rank=RANK,
                                                               remat=True))
    bt = fixed_batch(s)
    # the reference logprobs: the adapter-free model, in each package
    jbatch = jax_grpo.GRPOBatch(**{k: jnp.asarray(v) for k, v in bt.items()})
    jref = jax_grpo.compute_ref_logps(s.jmodel, s.params, jbatch)
    jbatch = jbatch._replace(ref_logps=jref)
    pmodel = Qwen2_5_VL_GP(pcfg)

    def loss_fn(lo):
        logps = jax_grpo._completion_logps(pmodel, jax_lora.insert_lora(s.params, lo), jbatch)
        cm = jbatch.completion_valid.astype(jnp.float32)
        return (jax_grpo.grpo_surrogate(logps, jbatch.advantages, cm)
                + 0.04 * jax_grpo.k3_kl(logps, jbatch.ref_logps, cm))

    jgrads = jax.grad(loss_fn)(lora)
    opt = optax.adamw(lr)
    jstep = jax_grpo.make_grpo_loss_step(pmodel, opt, 1.0, 0.04)
    jlora, _, jm = jstep(lora, opt.init(lora), s.params, jbatch)

    model = copy.deepcopy(s.tmodel)
    insert_lora(model, {p: {k: torch.as_tensor(np.asarray(v)) for k, v in ab.items()}
                        for p, ab in lora.items()}, cfg=pcfg)
    params = lora_parameters(model)
    batch = grpo.GRPOBatch(**{k: torch.as_tensor(v) for k, v in bt.items()})
    ref = grpo.compute_ref_logps(model, batch)
    assert_close(ref.numpy(), np.asarray(jref), bt["completion_valid"])
    batch = batch._replace(ref_logps=ref)
    ptrs = {n: p.data_ptr() for n, p in params.items()}
    metrics = grpo.make_grpo_loss_step(model, AdamW(params, lr), 1.0, 0.04)(batch)
    for k in ("reward_loss", "kd_loss", "grpo_total", "mean_advantage"):
        assert_close(metrics[k].numpy(), np.asarray(jm[k]))
    assert float(metrics["kd_loss"]) > 0
    for name, p in params.items():
        layer = int(name.split(".")[2])
        path = "text/layers/" + "/".join(name.split(".")[3:5]) + "/kernel"
        key = "a" if name.endswith("lora_a") else "b"
        assert_close(p.grad.numpy(), np.asarray(jgrads[path][key][layer]))
        assert p.data_ptr() == ptrs[name]  # updated in place
    got = lora_tree(model)
    for path, ab in jlora.items():
        for key in ("a", "b"):
            upd_t = got[path][key].numpy() - np.asarray(lora[path][key])
            upd_j = np.asarray(ab[key]) - np.asarray(lora[path][key])
            assert_close(upd_t, upd_j)


def _trainers(ratio):
    """The JAX and the port's GRPOTrainer on the same weights and seed."""
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.training.grpo import GRPOTrainer

    s = make_setup()
    kw = dict(num_generations=2, max_new_tokens=4, temperature=1.0, score_fn="dummy",
              lora_rank=RANK, learning_rate=1e-3, seed=5, gen_mask_usage_ratio=ratio)

    def tok(t):
        return [5 + ord(c) % 200 for c in t[:8]]

    def detok(ids):  # its length varies with the ids, so the rewards differ
        return " ".join(map(str, ids))

    jt = jax_grpo.GRPOTrainer(s.cfg, JaxRunner(s.cfg, s.params), None, tok, detok, **kw)
    tt = GRPOTrainer(s.cfg, GlimpsePruneRunner(s.cfg, copy.deepcopy(s.tmodel)), None, tok,
                     detok, **kw)
    return s, jt, tt, tok


def test_trainer_mask_mixing_matches_jax():
    """gen_mask_usage_ratio 0.5: the rows that take the policy's predicted
    masks are drawn from the same host RNG, and the predicted masks agree,
    over two steps' draws."""
    from glimpseprune_torch.models.qwen2_5_vl import inputs as torch_inputs
    from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner

    s, jt, tt, tok = _trainers(0.5)
    cfg = s.cfg
    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)
    p = [cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id] + tok("q?")
    boxes = [[[0.0, 0.0, 0.5, 0.5]], [[0.5, 0.5, 1.0, 1.0]]] * 2
    kw = dict(normed_bboxes=boxes, seq_multiple=8, patch_multiple=16)
    drawn = []
    for _step in range(2):
        prep_j = jax_runner.prepare_inputs(cfg, [p] * 4, [image] * 4, **kw)
        prep_t = torch_inputs.prepare_inputs(cfg, [p] * 4, [image] * 4, **kw)
        # the JAX trainer's mixing (grpo.py:316-330), on its own runner and RNG
        jt.policy_runner.params = jt._insert_lora(jt.frozen, jt.lora)
        ml, _ = jt.policy_runner.glimpse_delayed(prep_j, use_ref_masks=False)
        gen_keep = np.asarray(jax.nn.sigmoid(ml[-1]) > cfg.gp.reduce_threshold)
        use_gen = jt._host_rng.random(4) < 0.5
        want = prep_j.ref_token_masks.copy()
        want[use_gen] = gen_keep[use_gen]
        assert tt.mix_masks(prep_t)
        np.testing.assert_array_equal(prep_t.ref_token_masks, want)
        drawn += use_gen.tolist()
    assert 0 < sum(drawn) < len(drawn)  # both kinds of rows were drawn


def test_trainer_step_moves_only_the_adapters():
    import torch

    from glimpseprune_torch.training.data import TrainSample
    from glimpseprune_torch.training.lora import lora_tree

    s, _, tt, _ = _trainers(1.0)
    base = {n: p.detach().clone() for n, p in tt.model.named_parameters()
            if "lora_" not in n}
    ptrs = {n: p.data_ptr() for n, p in tt.lora.items()}
    samples = [TrainSample("what is this?", "a cat", "d0.jpg")]

    def load_image(path):
        return np.random.default_rng(1).integers(0, 255, (64, 96, 3), dtype=np.uint8)

    before = lora_tree(tt.model)
    m = tt.step_on_batch(samples, load_image, torch.Generator().manual_seed(0))
    assert all(np.isfinite(v) for v in m.values())
    assert abs(m["kd_loss"]) < 1e-6  # B starts at zero: the policy is the reference
    after = lora_tree(tt.model)
    moved = max(float((after[p]["b"] - before[p]["b"]).abs().max()) for p in after)
    assert moved > 0
    for n, p in tt.model.named_parameters():
        if "lora_" not in n:
            assert torch.equal(p, base[n]), n
    assert all(p.data_ptr() == ptrs[n] for n, p in tt.lora.items())
    m2 = tt.step_on_batch(samples, load_image, torch.Generator().manual_seed(1))
    assert np.isfinite(m2["grpo_total"]) and m2["kd_loss"] >= -1e-6

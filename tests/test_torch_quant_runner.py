"""The port's quantized serving tiers through ``GlimpsePruneRunner`` against
the JAX runner on the same tiny weights and inputs, with the JAX attention
in its Pallas kernels (interpret mode), so that the int8 attention tier runs
on both sides:

- (q8) int8 weights, W8A8 in prefill, int8 decode KV cache;
- (q4) int4 weights with W4A8 prefill, int8 ViT attention (QK and PV),
  int8 decode KV cache.

Greedy tokens must be identical, pruned and unpruned; the pruned prefill's
first logits and mask logits agree within the stated tolerance. Also: a
config knob that the port does not implement raises, a model whose weights
are not in the config's tier raises, and the int8 decode cache is built as
the JAX runner builds it."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu import quantization as jq
from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from glimpseprune_tpu.ops import attention as jax_attention
from test_torch_inputs import make_setup

TIERS = {
    "q8": ("int8", dict(act_quant="prefill")),
    "q4": ("int4", dict(act_quant="prefill", attn_qk_int8="vision", attn_pv_int8="vision")),
}
# fp32 on both sides; an int8 rounding of an activation, a q/k row or a
# probability can land on the other side of a tie where two fp32 sums
# differ in the last place, which moves a logit by ~1e-5 of the largest one
# (measured 3e-7 for q8, 1.2e-5 for q4); running the ViT's full attention
# without the int8 tier moves them by ~7e-4
LOGIT_RTOL = 1e-4


def _with_kv_int8(cfg):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, kv_cache_quant="int8"))


def _tier(name):
    """(setup, JAX config, quantized JAX params, port config, port model) of
    a tier on the shared tiny setup. The port's model is the unquantized
    one, quantized in place by quantize_model and bound there to the
    quantized config; (q8) takes the other route, the JAX package's
    quantized params through load_from_jax. Both give the same bytes."""
    from glimpseprune_torch import quantization as tq
    from glimpseprune_torch.config import tiny_test_config as torch_tiny
    from glimpseprune_torch.convert import load_from_jax

    s = make_setup()
    mode, kw = TIERS[name]
    jcfg = _with_kv_int8(jq.quantized_config(s.cfg, mode, **kw))
    tcfg = _with_kv_int8(tq.quantized_config(torch_tiny(), mode, **kw))
    qparams = (jq.quantize_int8 if mode == "int8" else jq.quantize_int4)(s.params)
    if name == "q8":
        model = load_from_jax(qparams, tcfg, device="cpu")
    else:
        model = tq.quantize_model(copy.deepcopy(s.tmodel), mode, cfg=tcfg)
    return s, jcfg, qparams, tcfg, model


@pytest.fixture
def flash_interpret():
    old = jax_attention.ATTENTION_IMPL
    jax_attention.ATTENTION_IMPL = "flash_interpret"
    yield
    jax_attention.ATTENTION_IMPL = old


@pytest.mark.parametrize("do_selection", [True, False])
@pytest.mark.parametrize("tier", ["q8", "q4"])
def test_quantized_generate_matches_jax_tokens(tier, do_selection, flash_interpret):
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s, jcfg, qparams, tcfg, tmodel = _tier(tier)
    want = jax_runner.GlimpsePruneRunner(jcfg, qparams).generate(
        s.prep_j, max_new_tokens=8, do_selection=do_selection)
    got = GlimpsePruneRunner(tcfg, tmodel).generate(s.prep_t, max_new_tokens=8,
                                                    do_selection=do_selection)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.num_generated, want.num_generated)
    if do_selection:
        np.testing.assert_array_equal(got.keep_img, want.keep_img)


@pytest.mark.parametrize("tier", ["q8", "q4"])
def test_quantized_prefill_logits_match_jax(tier, flash_interpret):
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s, jcfg, qparams, tcfg, tmodel = _tier(tier)
    want = jax_runner.GlimpsePruneRunner(jcfg, qparams).glimpse(s.prep_j)
    got = GlimpsePruneRunner(tcfg, tmodel).prefill(s.prep_t, do_selection=True)
    img_valid = np.asarray(s.prep_t.img_valid)
    for field, rows in (("logits", None), ("mask_logits", img_valid)):
        w = np.asarray(getattr(want, field), np.float32)
        g = getattr(got, field).float().numpy()
        if rows is not None:
            w, g = w[:, rows], g[:, rows]
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= LOGIT_RTOL, (field, err)


def test_weight_quant_int8_gives_jax_results():
    """weight_quant="int8" with the JAX package's quantized weights gives
    the JAX runner's logits (weight-only int8, fp32 compute): the port
    reads the quantized weights instead of running its own bf16 ones."""
    from glimpseprune_torch import quantization as tq
    from glimpseprune_torch.config import tiny_test_config as torch_tiny
    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    qparams = jq.quantize_int8(s.params)
    jcfg, tcfg = jq.quantized_config(s.cfg), tq.quantized_config(torch_tiny())
    want = jax_runner.GlimpsePruneRunner(jcfg, qparams).glimpse(s.prep_j)
    got = GlimpsePruneRunner(tcfg, load_from_jax(qparams, tcfg, device="cpu")).prefill(s.prep_t)
    w = np.asarray(want.logits, np.float32)
    np.testing.assert_allclose(got.logits.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0)
    # the same config over the unquantized model is refused, not run in fp32
    with pytest.raises(ValueError, match="weight_quant"):
        GlimpsePruneRunner(tcfg, s.tmodel)


def test_kv_cache_int8_built_like_jax():
    """Under kv_cache_quant="int8" the decode cache is the JAX runner's
    int8 cache (the prefix quantized once): the same int8 values, and
    scales within one fp32 ulp (XLA's jit of amax / 127 may multiply by the
    reciprocal instead)."""
    import torch

    from glimpseprune_torch.config import tiny_test_config as torch_tiny
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    kv = np.random.default_rng(0).standard_normal((4, 2, 9, 2, 16)).astype(np.float32)
    want = jax_runner._build_decode_cache(jnp.asarray(kv), t=13, quant="int8")
    runner = GlimpsePruneRunner(_with_kv_int8(torch_tiny()), s.tmodel)
    got = runner.decode_cache(torch.as_tensor(kv), 13)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]), rtol=2.4e-7, atol=0)
    plain = GlimpsePruneRunner(torch_tiny(), s.tmodel).decode_cache(torch.as_tensor(kv), 13)
    np.testing.assert_array_equal(plain[:, :, :9].numpy(), kv)


@pytest.mark.parametrize("field,value", [
    ("text.lora_rank", 2),
    ("text.kv_cache_quant", "fp8"),
    ("text.weight_quant", "nf4"),
    ("vision.act_quant", "all"),
    ("model_family", "llava"),
])
def test_runner_refuses_unported_knobs(field, value):
    from glimpseprune_torch.config import tiny_test_config as torch_tiny
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    cfg = torch_tiny()
    if "." in field:
        tower, knob = field.split(".")
        cfg = dataclasses.replace(cfg, **{tower: dataclasses.replace(getattr(cfg, tower),
                                                                     **{knob: value})})
    else:
        cfg = dataclasses.replace(cfg, **{field: value})
    with pytest.raises(ValueError, match=field.split(".")[-1]):
        GlimpsePruneRunner(cfg, make_setup().tmodel)


def test_runner_refuses_a_model_bound_to_another_config():
    """The model's config has one owner: a runner refuses a model bound to
    another config, and a runner whose model was re-bound since (here:
    quantized into another tier) refuses to run rather than run that tier."""
    from glimpseprune_torch import quantization as tq
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    qcfg = tq.quantized_config(s.cfg, "int8", act_quant="prefill")
    with pytest.raises(ValueError, match="act_quant"):
        GlimpsePruneRunner(qcfg, tq.quantize_model(copy.deepcopy(s.tmodel), "int8"))
    model = copy.deepcopy(s.tmodel)
    first = GlimpsePruneRunner(s.cfg, model)
    second = GlimpsePruneRunner(qcfg, tq.quantize_model(model, "int8", cfg=qcfg))
    with pytest.raises(ValueError, match="bound to another config"):
        first.prefill(s.prep_t)
    assert second.model is model and model.text.layers[0].cfg is qcfg.text

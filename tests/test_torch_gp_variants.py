"""GlimpsePrune config variants through the port's pruned ``generate``
against the JAX runner, each on its own random weights (the JAX init's
shapes for that config, shared through ``load_from_jax``, fp32):
``use_attention_logits`` (the raw harvest logits, as the 3B config has it),
corner ``anchor_positions``, ``le_length=2``, two ``selected_layers`` and
``reduce_layer=2``.

Tolerances: greedy tokens, counts and keep sets identical; mask logits
within 1e-4 of max |JAX| at valid image slots."""

import dataclasses

import pytest

from glimpseprune_tpu.config import tiny_test_config
from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from glimpseprune_tpu.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
from test_torch_gp_knobs import assert_same_generate, preps
from test_torch_inputs import make_batch_args, random_params

VARIANTS = {
    "attention_logits": dict(use_attention_logits=True),
    "anchors": dict(anchor_positions=("tl", "br")),
    "le_length_2": dict(le_length=2),
    "two_selected_layers": dict(selected_layers=(0, 1)),
    "reduce_layer_2": dict(reduce_layer=2, selected_layers=(2,)),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_generate_matches_jax(variant):
    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    base = tiny_test_config()
    cfg = dataclasses.replace(base, gp=dataclasses.replace(base.gp, **VARIANTS[variant]))
    prep_j, prep_t = preps(cfg, *make_batch_args(cfg, 0))
    if variant == "anchors":
        assert prep_t.anchor_mask is not None and prep_t.anchor_mask.sum() == 4
    params = random_params(Qwen2_5_VL_GP(cfg), prep_j, seed=3)
    want = jax_runner.GlimpsePruneRunner(cfg, params).generate(prep_j, max_new_tokens=8)
    got = GlimpsePruneRunner(cfg, load_from_jax(params, cfg, device="cpu")).generate(
        prep_t, max_new_tokens=8)
    assert_same_generate(got, want, img_valid=prep_j.img_valid)
    if variant == "anchors":
        assert got.keep_img[prep_t.anchor_mask].all()

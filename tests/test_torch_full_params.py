"""Full-model checkpoints and the reference's new-module file.

``persistence.save_full_params`` / ``load_full_params`` (the counterpart of
JAX persistence.py:156-171; round trips as tests/test_persistence.py:103-138
lists them, plus int4 and LLaVA): a model reloaded onto the meta device
holds every tensor of the saved one bit for bit (dtype, shape, strides)
and gives bit-identical greedy tokens and mask logits, in bf16, in the
int8 and int4 weight tiers, and for the tiny LLaVA. And a reference-layout
``new_modules_gp.pt`` (built as tests/test_persistence.py:41-100 builds
one) loads through the port's ``load_new_modules`` into the values that
JAX ``import_torch_new_modules`` followed by ``params_from_jax`` give."""

import copy
import dataclasses

import numpy as np
import pytest

TIERS = ("bf16", "int8", "int4", "llava")


def tier_model(tier):
    """(config, model, prep) of a tier on the tiny config: bf16 random
    weights from init_random; int8 / int4 the shared fp32 model quantized
    in place, with W8A8 / W4A8 prefill (int4 also int8 ViT attention) and
    an int8 KV cache; and the tiny LLaVA (fp32), whose CLIP tower's config
    is saved beside the model's."""
    import torch

    from glimpseprune_torch import quantization as tq
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import init_random
    from test_torch_inputs import make_setup

    cfg = tiny_test_config()
    prep = make_setup().prep_t
    if tier == "bf16":
        return cfg, init_random(cfg, 0, "cpu", torch.bfloat16), prep
    if tier == "llava":
        from glimpseprune_torch.models.llava import gp_model, runner
        from test_torch_llava import batch_args, tiny_configs

        cfg, cc = tiny_configs(gp_model)
        prep = runner.prepare_llava_inputs(cfg, cc, *batch_args(), seq_multiple=8)
        return cfg, init_random(cfg, 0, "cpu", torch.float32, clip_cfg=cc), prep
    kw = dict(act_quant="prefill")
    if tier == "int4":
        kw.update(attn_qk_int8="vision", attn_pv_int8="vision")
    qcfg = tq.quantized_config(cfg, tier, **kw)
    qcfg = dataclasses.replace(qcfg, text=dataclasses.replace(qcfg.text,
                                                              kv_cache_quant="int8"))
    return qcfg, tq.quantize_model(copy.deepcopy(make_setup().tmodel), tier, cfg=qcfg), prep


@pytest.mark.parametrize("tier", TIERS)
def test_full_params_round_trip_bit_identical(tier, tmp_path):
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.persistence import load_full_params, save_full_params

    cfg, model, prep = tier_model(tier)
    want = [GlimpsePruneRunner(cfg, model).generate(prep, max_new_tokens=8, do_selection=d)
            for d in (True, False)]
    save_full_params(model, cfg, str(tmp_path))
    loaded, lcfg = load_full_params(str(tmp_path), device="cpu")
    assert lcfg == cfg
    assert getattr(loaded, "clip_cfg", None) == getattr(model, "clip_cfg", None)
    assert not any(t.is_meta for t in loaded.state_dict().values())
    a, b = model.state_dict(), loaded.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert (a[k].dtype, a[k].shape, a[k].stride()) == (b[k].dtype, b[k].shape,
                                                           b[k].stride()), k
        assert torch.equal(a[k], b[k]), k
    assert not any(p.requires_grad for p in loaded.parameters())
    got = [GlimpsePruneRunner(lcfg, loaded).generate(prep, max_new_tokens=8, do_selection=d)
           for d in (True, False)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.sequences, w.sequences)
        np.testing.assert_array_equal(g.num_generated, w.num_generated)
    np.testing.assert_array_equal(got[0].keep_img, want[0].keep_img)
    np.testing.assert_array_equal(got[0].mask_logits, want[0].mask_logits)


def reference_new_modules(cfg):
    """A reference-layout new_modules_gp.pt state (model_gp.py
    _init_new_modules' module structure), as tests/test_persistence.py
    builds one."""
    import torch

    gp = cfg.gp
    F, C, H = gp.attn_fuse_size, gp.visual_cond_size, cfg.text.hidden_size
    qk = F + C
    n_attn_in = len(gp.selected_layers) * cfg.text.num_attention_heads
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    sd = {"attn_in_proj.weight": randn(F, n_attn_in), "attn_in_proj.bias": randn(F)}
    for i in range(len(gp.selected_visual_layers)):
        sd[f"cond_in_projs.{i}.weight"] = randn(C, cfg.vision.hidden_size)
        sd[f"cond_in_projs.{i}.bias"] = randn(C)
        sd[f"layers.{i}.norm1.weight"] = randn(F)
        sd[f"layers.{i}.norm2.weight"] = randn(F)
        for n, shape in (("q_proj", (qk, qk)), ("k_proj", (qk, qk)), ("v_proj", (F, F)),
                         ("o_proj", (F, F))):
            sd[f"layers.{i}.attn.{n}.weight"] = randn(*shape)
        for n, shape in (("gate_proj", (2 * F, F)), ("up_proj", (2 * F, F)),
                         ("down_proj", (F, 2 * F))):
            sd[f"layers.{i}.mlp.{n}.weight"] = randn(*shape)
            sd[f"layers.{i}.mlp.{n}.bias"] = randn(shape[0])
        sd[f"attn_out_projs.{i}.weight"] = randn(1, F)
        sd[f"attn_out_projs.{i}.bias"] = randn(1)
    return {"attn_fuser": sd,
            "learnable_embeddings": randn(len(gp.le_layers), gp.le_length, H),
            "le_proj": {"weight": randn(H, H), "bias": randn(H)},
            "le_norm": {"weight": randn(H)}}


def test_reference_new_modules_file_loads_as_jax(tmp_path):
    import torch

    from glimpseprune_tpu.persistence import import_torch_new_modules
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import params_from_jax
    from glimpseprune_torch.persistence import NEW_MODULES_FILE, load_new_modules
    from test_torch_inputs import make_setup

    s = make_setup()
    state = reference_new_modules(s.cfg)
    torch.save(state, str(tmp_path / NEW_MODULES_FILE))
    tiny_test_config().save(str(tmp_path))
    model, saved = load_new_modules(copy.deepcopy(s.tmodel), str(tmp_path))
    assert saved == tiny_test_config()
    want = params_from_jax({**s.params, **import_torch_new_modules(state, s.cfg)}, s.cfg)
    got = model.state_dict()
    new = [k for k in want if k.split(".")[0] in ("attn_fuser", "learnable_embeddings",
                                                  "le_proj", "le_norm")]
    assert len(new) == sum(1 for k in got if k.split(".")[0] in ("attn_fuser",
                           "learnable_embeddings", "le_proj", "le_norm"))
    for k in new:
        assert torch.equal(got[k], want[k]), k
    base = s.tmodel.state_dict()
    for k in set(got) - set(new):  # the base model is untouched
        assert torch.equal(got[k], base[k]), k

"""The port's LLaVA-1.5 family (glimpseprune_torch/models/llava/) against the
JAX package's on the same tiny weights and inputs: the CLIP tower (features,
taps, CDPruner's projection, VisionZip's importance) on an image that is
not symmetric, the HF towers through the port's converter, the input prep
field by field, pruned and unpruned generation, the all-kept equivalence,
the oracle masks, the five compressors (CDPruner with the CLIP-text
relevance too), the int8 tier and two train steps; and the runner's
refusals. fp32 on the CPU, the kernels' plain versions. The tiny configs
are tests/test_llava.py's, with its CDPruner text tower."""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from glimpseprune_tpu import quantization as jq
from glimpseprune_tpu.models.llava import gp_model as jgp
from glimpseprune_tpu.models.llava import runner as jrunner
from glimpseprune_tpu.ops.rope import mrope_cos_sin as jax_mrope_cos_sin
from glimpseprune_tpu.training.train_step import init_train_state, make_train_step
from test_torch_inputs import assert_same_fields, random_params

TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 sums taken in another order
HF_TOL = dict(atol=3e-4, rtol=3e-4)  # tests/test_llava.py's against HF


def tiny_configs(pkg):
    """(ModelConfig, CLIPTowerConfig) of a gp_model module (JAX or port):
    tests/test_llava.py's tiny LLaVA with its CDPruner text tower."""
    clip = pkg.CLIPTowerConfig(
        depth=3, hidden_size=32, num_heads=4, intermediate_size=64, patch_size=14,
        image_size=56, feature_layer=-2, with_text_tower=True, projection_dim=24,
        text_depth=2, text_hidden_size=32, text_num_heads=4, text_intermediate_size=64,
        text_vocab_size=128, text_max_positions=16)
    text = pkg.llama_text_config(hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                                 num_attention_heads=4, num_key_value_heads=4, vocab_size=512,
                                 rms_norm_eps=1e-6)
    gp = dataclasses.replace(
        pkg.llava_config().gp, selected_layers=(1,), reduce_layer=1,
        selected_visual_layers=(1, 0), attn_fuse_size=16, visual_cond_size=16,
        attn_fuse_num_heads=4, le_layers=(0, 1, 2), max_remain_ratio=0.5)
    cfg = dataclasses.replace(pkg.llava_config(clip=clip, text=text, gp=gp),
                              image_token_id=500, eos_token_id=502, pad_token_id=0)
    return cfg, clip


def batch_args(seed=0):
    """Two rows; a 80x100 image (padded to a square, then resized) and a
    56x56 one (no resize); a box on row 0."""
    rng = np.random.default_rng(seed)
    prompts = [[7, 8, 500, 9, 10], [11, 500, 12, 13, 14]]
    images = [rng.integers(0, 255, (80, 100, 3), dtype=np.uint8),
              rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    return prompts, images


TEXT_IDS = np.array([[126, 30, 40, 127] + [0] * 12, [126, 55, 127] + [0] * 13], np.int32)


@functools.lru_cache(maxsize=None)
def setup():
    """Both packages' configs, one prep each, random JAX params, the port's
    model on them (fp32, CPU) and the JAX runner."""
    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.models.llava import gp_model as tgp
    from glimpseprune_torch.models.llava import runner as trunner

    cfg_j, cc_j = tiny_configs(jgp)
    cfg_t, cc_t = tiny_configs(tgp)
    prompts, images = batch_args()
    boxes = [[[0.0, 0.0, 0.5, 0.5]], [[0.5, 0.25, 1.0, 1.0]]]
    prep_j = jrunner.prepare_llava_inputs(cfg_j, cc_j, prompts, images, normed_bboxes=boxes,
                                          seq_multiple=8)
    prep_t = trunner.prepare_llava_inputs(cfg_t, cc_t, prompts, images, normed_bboxes=boxes,
                                          seq_multiple=8)
    jmodel = jgp.Llava_GP(cfg_j, clip_cfg=cc_j)
    params = random_params(jmodel, prep_j, 0)
    tmodel = load_from_jax(params, cfg_t, device="cpu", clip_cfg=cc_t)
    return SimpleNamespace(cfg_j=cfg_j, cc_j=cc_j, cfg_t=cfg_t, cc_t=cc_t, prep_j=prep_j,
                           prep_t=prep_t, jmodel=jmodel, params=params, tmodel=tmodel,
                           jrun=jrunner.make_llava_runner(cfg_j, cc_j, params))


def port_runner(cfg_t=None, model=None):
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = setup()
    return GlimpsePruneRunner(cfg_t or s.cfg_t, model or s.tmodel)


def test_clip_tower_matches_jax():
    """Features, taps, importance and CDPruner's embeds on pixels that are
    not symmetric; the conv kernel with kh and kw swapped (the blanket .T
    of a 2-D kernel applied to the 4-D one) must fail the same check."""
    import torch

    s = setup()
    rng = np.random.default_rng(5)
    px = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    feats_j, taps_j, (cls_j, keys_j), emb_j = s.jmodel.apply(
        {"params": s.params}, jnp.asarray(px),
        method=lambda m, p: m.visual(p, emit_importance=True, emit_embeds=True))
    with torch.no_grad():
        feats, taps, (cls, keys), emb = s.tmodel.visual(torch.as_tensor(px),
                                                        emit_importance=True, emit_embeds=True)
        for got, want in ((feats, feats_j), (taps[0], taps_j[0]), (taps[1], taps_j[1]),
                          (cls, cls_j), (keys, keys_j), (emb, emb_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        w = s.tmodel.visual.patch_embedding.weight
        w.copy_(w.transpose(2, 3).clone())
        swapped = s.tmodel.visual(torch.as_tensor(px))[0]
        w.copy_(w.transpose(2, 3).clone())
    assert not np.allclose(swapped.numpy(), np.asarray(feats_j), **TOL)


@pytest.mark.parametrize("route", ["init_random", "to"])
def test_clip_layernorms_keep_fp32_values_in_bf16(route):
    """CLIP's LayerNorm scales and biases (flax param_dtype float32) hold
    their fp32 values bit for bit in a bf16 model: taken from a base dict
    by init_random, or kept through model.to(bfloat16)."""
    import torch

    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.llava.clip import FP32LayerNorm

    s = setup()
    rng = np.random.default_rng(3)
    norms = {f"{n}.{leaf}" for n, m in s.tmodel.named_modules()
             if isinstance(m, FP32LayerNorm) for leaf in ("weight", "bias")}
    base = {k: (torch.as_tensor(1.0 + rng.standard_normal(v.shape).astype(np.float32))
                if k in norms else v.clone()) for k, v in s.tmodel.state_dict().items()}
    assert not all(torch.equal(base[k], base[k].bfloat16().float()) for k in norms)
    if route == "init_random":
        model = init_random(s.cfg_t, 0, "cpu", torch.bfloat16, clip_cfg=s.cc_t, base=base)
    else:
        model = init_random(s.cfg_t, 0, "cpu", torch.float32, clip_cfg=s.cc_t,
                            base=base).to(torch.bfloat16)
    got = model.state_dict()
    assert any(k.startswith("clip_text.") for k in norms)
    for k in norms:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], base[k]), k
    assert got["visual.layers.0.mlp.fc1.weight"].dtype == torch.bfloat16


def test_llama_rope_reads_channel_zero():
    """Llama's one mRoPE section (64,) reads position channel 0 only, as
    the JAX tables do: channels 1 and 2 may hold anything."""
    import torch

    from glimpseprune_torch.ops.rope import mrope_cos_sin

    rng = np.random.default_rng(0)
    pos = rng.integers(0, 900, (3, 2, 7))
    cos, sin = mrope_cos_sin(torch.as_tensor(pos), 128, 10000.0, (64,))
    pos2 = pos.copy()
    pos2[1:] = rng.integers(0, 900, (2, 2, 7))
    cos2, sin2 = mrope_cos_sin(torch.as_tensor(pos2), 128, 10000.0, (64,))
    assert torch.equal(cos, cos2) and torch.equal(sin, sin2)
    cos_j, sin_j = jax_mrope_cos_sin(jnp.asarray(pos), 128, 10000.0, (64,))
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_j), atol=1e-6)


def _hf_clip(kind):
    """A tiny HF CLIP model of tests/test_llava.py's sizes."""
    import torch
    from transformers import (CLIPTextConfig, CLIPTextModelWithProjection, CLIPVisionConfig,
                              CLIPVisionModelWithProjection)

    _, cc = tiny_configs(jgp)
    torch.manual_seed(0)
    if kind == "text":
        return CLIPTextModelWithProjection(CLIPTextConfig(
            vocab_size=cc.text_vocab_size, hidden_size=cc.text_hidden_size,
            intermediate_size=cc.text_intermediate_size, num_hidden_layers=cc.text_depth,
            num_attention_heads=cc.text_num_heads, max_position_embeddings=cc.text_max_positions,
            projection_dim=cc.projection_dim, hidden_act="quick_gelu", eos_token_id=127,
            bos_token_id=126, pad_token_id=0)).eval()
    return CLIPVisionModelWithProjection(CLIPVisionConfig(
        hidden_size=cc.hidden_size, intermediate_size=cc.intermediate_size,
        num_hidden_layers=cc.depth, num_attention_heads=cc.num_heads,
        image_size=cc.image_size, patch_size=cc.patch_size, projection_dim=cc.projection_dim,
        hidden_act="quick_gelu")).eval()


@pytest.mark.parametrize("kind", ["vision", "text"])
def test_clip_towers_match_hf(kind):
    """The CLIP towers converted from HF's state dicts (convert_clip /
    convert_clip_text) against HF's forward, and equal to the JAX
    converter's weights."""
    import torch

    from glimpseprune_torch.convert import params_from_jax
    from glimpseprune_torch.models.llava import convert as tconv
    from glimpseprune_torch.models.llava.clip import CLIPTextTower, CLIPVisionTower
    from glimpseprune_tpu.models.llava import convert as jconv

    s = setup()
    hf = _hf_clip(kind)
    if kind == "vision":
        sd = {**{"vision_model." + k: v for k, v in hf.vision_model.state_dict().items()},
              "visual_projection.weight": hf.visual_projection.weight}
        state = tconv.convert_clip(tconv._strip_llava_prefixes(sd), s.cc_t)
        want = params_from_jax({"visual": jconv.convert_clip(jconv._strip_llava_prefixes(sd),
                                                             s.cc_j)}, s.cfg_j)
        tower, prefix = CLIPVisionTower(s.cc_t, tap_layers=(0,)), "visual."
        px = np.random.default_rng(0).standard_normal((2, 56, 56, 3)).astype(np.float32)
        with torch.no_grad():
            out = hf.vision_model(torch.as_tensor(px.transpose(0, 3, 1, 2)),
                                  output_hidden_states=True)
            feats = out.hidden_states[-2][:, 1:]
            ref = [feats, hf.visual_projection(hf.vision_model.post_layernorm(feats))]
    else:
        sd = hf.state_dict()
        state = tconv.convert_clip_text(sd, s.cc_t)
        want = params_from_jax({"clip_text": jconv.convert_clip_text(sd, s.cc_j)}, s.cfg_j)
        tower, prefix = CLIPTextTower(s.cc_t), "clip_text."
        rng = np.random.default_rng(2)
        ids = np.zeros((3, 16), dtype=np.int64)
        for m in range(3):  # [bos, tokens, eot (the largest id), zero padding]
            n = 5 + m
            ids[m, 0], ids[m, 1:1 + n], ids[m, 1 + n] = 126, rng.integers(3, 120, n), 127
        with torch.no_grad():
            ref = [hf(torch.as_tensor(ids)).text_embeds]
    assert set(state) == set(want)
    for k, v in want.items():
        assert torch.equal(state[k].float(), v), k
    tower.load_state_dict({k[len(prefix):]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        if kind == "vision":
            feats, _, emb = tower(torch.as_tensor(px), emit_embeds=True)
            got = [feats, emb]
        else:
            got = [tower(torch.as_tensor(ids))]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **HF_TOL)


@pytest.mark.parametrize("layout", ["merged", "separate"])
def test_llava_hf_converter_matches_jax_and_hf(layout):
    """convert_llava_state_dict on a LLaVA-1.5 dict (the merged layout, or
    the CLIP and Llama dicts side by side): the JAX converter's weights
    exactly, every base parameter of the model, none of the GlimpsePrune
    modules; the Llama decoder's logits against HF's."""
    import torch
    from transformers import LlamaConfig, LlamaForCausalLM

    from glimpseprune_torch.convert import params_from_jax
    from glimpseprune_torch.models.llava import convert as tconv
    from glimpseprune_torch.training.train_step import new_module_filter
    from glimpseprune_tpu.models.llava import convert as jconv

    s = setup()
    t = s.cfg_t.text
    torch.manual_seed(1)
    llama = LlamaForCausalLM(LlamaConfig(
        vocab_size=t.vocab_size, hidden_size=t.hidden_size,
        intermediate_size=t.intermediate_size, num_hidden_layers=t.num_hidden_layers,
        num_attention_heads=t.num_attention_heads, num_key_value_heads=t.num_key_value_heads,
        rms_norm_eps=t.rms_norm_eps, rope_theta=t.rope_theta, attention_bias=False)).eval()
    clip = _hf_clip("vision")
    proj = torch.nn.Sequential(torch.nn.Linear(s.cc_t.hidden_size, t.hidden_size),
                               torch.nn.GELU(), torch.nn.Linear(t.hidden_size, t.hidden_size))
    if layout == "merged":
        sd = {**{"model.vision_tower.vision_tower.vision_model." + k: v
                 for k, v in clip.vision_model.state_dict().items()},
              **{"model.mm_projector." + k: v for k, v in proj.state_dict().items()},
              **llama.state_dict()}
    else:
        sd = {**{"vision_model." + k: v for k, v in clip.vision_model.state_dict().items()},
              **{"mm_projector." + k: v for k, v in proj.state_dict().items()},
              **llama.state_dict()}
    sd["visual_projection.weight"] = clip.visual_projection.weight
    state = tconv.convert_llava_state_dict(sd, s.cfg_t, s.cc_t)
    want = params_from_jax(jconv.convert_llava_state_dict(sd, s.cfg_j, s.cc_j), s.cfg_j)
    assert set(state) == set(want)
    for k, v in want.items():
        assert torch.equal(state[k].float(), v), k
    slots = set(s.tmodel.state_dict())
    assert set(state) <= slots
    missing = slots - set(state) - {k for k in slots if k.startswith("clip_text.")}
    assert missing and all(new_module_filter(k) for k in missing), sorted(missing)
    assert not any(new_module_filter(k) for k in state)

    from glimpseprune_torch.models.llava.runner import make_llava_runner

    model = make_llava_runner(s.cfg_t, s.cc_t, state, "cpu", torch.float32).model
    assert model.text.layers[1].mlp.up_proj.weight.data_ptr() == state[
        "text.layers.1.mlp.up_proj.weight"].data_ptr()  # taken, not copied
    ids = np.random.default_rng(1).integers(3, 500, size=(2, 9))
    pos = torch.as_tensor(np.broadcast_to(np.arange(9), (3, 2, 9)).copy())
    with torch.no_grad():
        ref = llama(torch.as_tensor(ids)).logits
        got = model.text_prefill_logits(torch.as_tensor(ids), torch.ones((2, 9), dtype=bool),
                                        pos)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **HF_TOL)


@pytest.mark.parametrize("case", ["bboxes", "answers", "anchors", "resize_all"])
def test_prepare_llava_inputs_equals_jax(case):
    from glimpseprune_torch.models.llava import gp_model as tgp
    from glimpseprune_torch.models.llava import runner as trunner

    cfg_j, cc_j = tiny_configs(jgp)
    cfg_t, cc_t = tiny_configs(tgp)
    prompts, images = batch_args(1)
    kw = dict(seq_multiple=8)
    if case == "bboxes":
        kw["normed_bboxes"] = [[[0.1, 0.0, 0.6, 0.5], [0.7, 0.7, 0.9, 1.0]], None]
    elif case == "answers":
        kw.update(answer_ids=[[11, 12, 13], [14]], normed_bboxes=[[[0, 0, 1, 1]]] * 2)
    elif case == "anchors":
        cfg_j, cfg_t = (c.replace_gp(anchor_positions=("tl", "br"), max_remain_ratio=0.25)
                        for c in (cfg_j, cfg_t))
    else:
        images = [np.random.default_rng(2).integers(0, 255, (30, 41), dtype=np.uint8),
                  np.random.default_rng(3).integers(0, 255, (70, 64, 4), dtype=np.uint8)]
    want = jrunner.prepare_llava_inputs(cfg_j, cc_j, prompts, images, **kw)
    got = trunner.prepare_llava_inputs(cfg_t, cc_t, prompts, images, **kw)
    assert_same_fields(want, got)
    for im in images:
        np.testing.assert_array_equal(trunner.expand_to_square_and_resize(im, 56),
                                      jrunner.expand_to_square_and_resize(im, 56))


@pytest.mark.parametrize("is_sft", [False, True])
def test_prepare_llava_chat_inputs_equals_jax(is_sft):
    from glimpseprune_torch.models.llava import gp_model as tgp
    from glimpseprune_torch.models.llava import runner as trunner

    cfg_j, cc_j = tiny_configs(jgp)
    cfg_t, cc_t = tiny_configs(tgp)
    _, images = batch_args(2)
    convs = [[{"role": "user", "content": [{"type": "image"}, {"type": "text",
                                                                "text": "what is it"}]}],
             [{"role": "user", "content": [{"type": "image"}, {"type": "text",
                                                                "text": "count the dots"}]}]]
    if is_sft:
        for c, a in zip(convs, ("a cat", "three")):
            c.append({"role": "assistant", "content": a})

    def tokenize(text):
        return [3 + (ord(ch) % 90) for ch in text]

    want = jrunner.prepare_llava_chat_inputs(cfg_j, cc_j, convs, images, tokenize,
                                             is_sft=is_sft, seq_multiple=8)
    got = trunner.prepare_llava_chat_inputs(cfg_t, cc_t, convs, images, tokenize,
                                            is_sft=is_sft, seq_multiple=8)
    assert_same_fields(want, got)


def test_glimpse_matches_jax():
    """The pruned prefill: mask logits, then the same keep set, compacted
    ids, positions and KV, and the first logits."""
    s = setup()
    want = s.jrun.glimpse(s.prep_j)
    got = port_runner().glimpse(s.prep_t)
    np.testing.assert_allclose(got.mask_logits.numpy(), np.asarray(want.mask_logits), **TOL)
    keep = got.keep_img.numpy()
    np.testing.assert_array_equal(keep, np.asarray(want.keep_img))
    assert 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(got.input_ids.numpy(), np.asarray(want.input_ids))
    np.testing.assert_array_equal(got.position_ids.numpy(), np.asarray(want.position_ids))
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_allclose(got.kv_k.numpy()[:, valid], np.asarray(want.kv_k)[:, valid],
                               **TOL)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **TOL)


@pytest.mark.parametrize("do_selection", [True, False])
def test_generate_matches_jax(do_selection):
    s = setup()
    want = s.jrun.generate(s.prep_j, max_new_tokens=6, do_selection=do_selection)
    got = port_runner().generate(s.prep_t, max_new_tokens=6, do_selection=do_selection)
    np.testing.assert_array_equal(got.sequences, np.asarray(want.sequences))
    np.testing.assert_array_equal(got.num_generated, np.asarray(want.num_generated))
    if do_selection:
        np.testing.assert_array_equal(got.keep_img, np.asarray(want.keep_img))


def test_all_kept_equals_unpruned():
    """With reduce_threshold -1 and no ratio cap every image token is kept,
    and the pruned run's tokens are the unpruned run's (JAX
    test_llava_gp_generate), and JAX's."""
    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.models.llava import runner as trunner

    s = setup()
    cfg_t = s.cfg_t.replace_gp(max_remain_ratio=None, reduce_threshold=-1.0)
    cfg_j = s.cfg_j.replace_gp(max_remain_ratio=None, reduce_threshold=-1.0)
    prompts, images = batch_args()
    prep_t = trunner.prepare_llava_inputs(cfg_t, s.cc_t, prompts, images, seq_multiple=8)
    prep_j = jrunner.prepare_llava_inputs(cfg_j, s.cc_j, prompts, images, seq_multiple=8)
    run = port_runner(cfg_t, load_from_jax(s.params, cfg_t, device="cpu", clip_cfg=s.cc_t))
    pruned = run.generate(prep_t, max_new_tokens=6, do_selection=True)
    unpruned = run.generate(prep_t, max_new_tokens=6, do_selection=False)
    assert pruned.keep_img.all()
    np.testing.assert_array_equal(pruned.sequences, unpruned.sequences)
    want = jrunner.make_llava_runner(cfg_j, s.cc_j, s.params).generate(
        prep_j, max_new_tokens=6, do_selection=True)
    np.testing.assert_array_equal(pruned.sequences, np.asarray(want.sequences))


def test_use_ref_masks_matches_jax():
    s = setup()
    want = s.jrun.generate(s.prep_j, max_new_tokens=4, use_ref_masks=True)
    got = port_runner().generate(s.prep_t, max_new_tokens=4, use_ref_masks=True)
    np.testing.assert_array_equal(got.keep_img, np.asarray(want.keep_img))
    assert not (got.keep_img & ~s.prep_t.ref_token_masks).any()
    np.testing.assert_array_equal(got.sequences, np.asarray(want.sequences))


COMPRESSORS = [
    ("visionzip", {"dominant_ratio": 0.3, "contextual_ratio": 0.1}),
    ("divprune", {"visual_token_num": 3}),
    ("cdpruner", {"visual_token_num": 3}),
    ("cdpruner", {"visual_token_num": 3, "clip_text_ids": TEXT_IDS}),
    ("vscan", {"visual_token_num": 4}),
    ("pdrop", {"stages": ((1, 0.5),)}),
]


@pytest.mark.parametrize("method,kw", COMPRESSORS,
                         ids=[m + ("+text" if "clip_text_ids" in k else "")
                              for m, k in COMPRESSORS])
def test_compressors_match_jax(method, kw):
    s = setup()
    want = s.jrun.generate_compressed(s.prep_j, method, max_new_tokens=3, **kw)
    got = port_runner().generate_compressed(s.prep_t, method, max_new_tokens=3, **kw)
    np.testing.assert_array_equal(got.sequences, np.asarray(want.sequences))
    np.testing.assert_allclose(got.prune_ratio, np.asarray(want.prune_ratio))
    if want.keep_img is None:
        assert got.keep_img is None
    else:
        np.testing.assert_array_equal(got.keep_img, np.asarray(want.keep_img))
    assert (got.prune_ratio > 0).all()


def test_cdpruner_relevance_matches_jax():
    """The CLIP-text relevance itself, against JAX's."""
    import torch

    s = setup()
    want = s.jmodel.apply({"params": s.params}, jnp.asarray(s.prep_j.patches),
                          jnp.asarray(TEXT_IDS), method=s.jmodel.cdpruner_relevance)
    with torch.no_grad():
        got = s.tmodel.cdpruner_relevance(torch.as_tensor(s.prep_t.patches),
                                          torch.as_tensor(TEXT_IDS, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_tier_matches_jax():
    """JAX test_llava_quantized_decoder's tier: int8 weights on the Llama
    stack and the head, CLIP unquantized though the config declares int8
    in both towers; the same int8 bytes, keep set and tokens."""
    import torch

    from glimpseprune_torch import quantization as tq
    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.models.layers import QuantLinear

    s = setup()
    qparams = jq.quantize_int8(s.params)
    qcfg_j = jq.quantized_config(s.cfg_j)
    qcfg_t = tq.quantized_config(s.cfg_t)
    model = load_from_jax(qparams, qcfg_t, device="cpu", clip_cfg=s.cc_t)
    assert not any(isinstance(m, QuantLinear) for m in model.visual.modules())
    q = model.text.layers[2].mlp.down_proj
    assert isinstance(q, QuantLinear) and isinstance(model.text.lm_head, QuantLinear)
    inplace = tq.quantize_model(load_from_jax(s.params, s.cfg_t, device="cpu",
                                              clip_cfg=s.cc_t), "int8", cfg=qcfg_t)
    assert torch.equal(inplace.text.layers[2].mlp.down_proj.kernel_q, q.kernel_q)
    jrun = jrunner.make_llava_runner(qcfg_j, s.cc_j, qparams)
    run = port_runner(qcfg_t, model)
    for do_sel in (True, False):
        want = jrun.generate(s.prep_j, max_new_tokens=5, do_selection=do_sel)
        got = run.generate(s.prep_t, max_new_tokens=5, do_selection=do_sel)
        np.testing.assert_array_equal(got.sequences, np.asarray(want.sequences))
        if do_sel:
            np.testing.assert_array_equal(got.keep_img, np.asarray(want.keep_img))


def test_train_steps_match_jax():
    """Two base train steps over Llava_GP (JAX test_llava_gp_train_step's
    recipe, AdamW with clipping): the losses, the glimpse modules after
    the steps, and the frozen base untouched."""
    import torch

    from glimpseprune_torch.convert import load_from_jax, params_from_jax
    from glimpseprune_torch.models.llava import runner as trunner
    from glimpseprune_torch.training import train_step as tstep
    from glimpseprune_torch.training.trainer import batch_from_prep

    s = setup()
    prompts, images = batch_args(4)
    kw = dict(normed_bboxes=[[[0.1, 0.1, 0.6, 0.6]], [[0.4, 0.0, 1.0, 0.7]]],
              answer_ids=[[11, 12, 13], [14, 15]], seq_multiple=8)
    prep_t = trunner.prepare_llava_inputs(s.cfg_t, s.cc_t, prompts, images, **kw)
    lr, n_steps = 5e-3, 2
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, weight_decay=0.01))
    state, frozen = init_train_state(s.params, opt)
    step_j = jax.jit(make_train_step(s.cfg_j, s.jmodel, opt))
    batch_j = {k: jnp.asarray(v.numpy()) for k, v in batch_from_prep(prep_t, "cpu").items()}
    assert set(batch_j) >= {"patches", "labels", "ref_token_masks"}
    losses_j = []
    for i in range(n_steps):
        state, m = step_j(state, frozen, batch_j, jax.random.PRNGKey(i))
        losses_j.append(float(m["loss"]))

    model = load_from_jax(s.params, s.cfg_t, device="cpu", clip_cfg=s.cc_t)
    base0 = {k: v.clone() for k, v in model.state_dict().items()
             if not tstep.new_module_filter(k)}
    adamw = tstep.AdamW(tstep.init_trainable(model), lr, weight_decay=0.01, max_grad_norm=1.0)
    step = tstep.make_train_step(s.cfg_t, model, adamw)
    batch = batch_from_prep(prep_t, "cpu")
    losses = [float(step(batch)["loss"]) for _ in range(n_steps)]
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    assert np.isfinite(losses).all()
    want = params_from_jax({**s.params, **state.trainable}, s.cfg_j)
    start = params_from_jax(s.params, s.cfg_j)
    for name, p in adamw.params.items():
        assert (want[name] != start[name]).any(), name
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=n_steps * lr
                                   * 1e-2, err_msg=name)
    for k, v in model.state_dict().items():
        if k in base0:
            assert torch.equal(v, base0[k]), k


def test_runner_refuses_mismatched_family():
    """clip_text_ids on a Qwen model (or a LLaVA model with another
    method, or one built without the CLIP text tower), a LLaVA config over
    a Qwen2_5_VL_GP and a Qwen config over a Llava_GP are refused, each
    naming the knob."""
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from test_torch_inputs import make_setup

    import torch

    q = make_setup()
    with pytest.raises(ValueError, match="clip_text_ids"):
        GlimpsePruneRunner(q.cfg, q.tmodel).generate_compressed(
            q.prep_t, "cdpruner", visual_token_num=3, clip_text_ids=TEXT_IDS)
    s = setup()
    with pytest.raises(ValueError, match="clip_text_ids"):
        port_runner().generate_compressed(s.prep_t, "divprune", visual_token_num=3,
                                          clip_text_ids=TEXT_IDS)
    bare = init_random(s.cfg_t, 0, "cpu", torch.float32,
                       clip_cfg=dataclasses.replace(s.cc_t, with_text_tower=False))
    with pytest.raises(ValueError, match="clip_text_ids"):
        port_runner(model=bare).generate_compressed(s.prep_t, "cdpruner", visual_token_num=3,
                                                    clip_text_ids=TEXT_IDS)
    qwen = init_random(tiny_test_config(), 0, "cpu", torch.float32)
    llava_cfg = dataclasses.replace(tiny_test_config(), model_family="llava")
    with pytest.raises(ValueError, match="model_family"):
        GlimpsePruneRunner(llava_cfg, qwen.set_config(llava_cfg))
    with pytest.raises(ValueError, match="model_family"):
        GlimpsePruneRunner(dataclasses.replace(s.cfg_t, model_family="qwen2_5_vl"), s.tmodel)

"""The port's HF Qwen2.5-VL converter (glimpseprune_torch/models/qwen2_5_vl/
convert.py) against the JAX package's and against HF's own forward, on
tests/test_model_parity.py's tiny random ``Qwen2_5_VLForConditionalGeneration``:
the converted weights equal ``params_from_jax`` of the JAX converter's,
exactly, in both key layouts and with tied, untied and headless
checkpoints; the converted model's ViT and decoder match HF within the JAX
test's 2e-4; ``hf_config_to_model_config`` of the config object and of its
config.json dict equal the JAX one's."""

import dataclasses
import functools
import json

import numpy as np
import pytest

from glimpseprune_tpu.config import tiny_test_config
from glimpseprune_tpu.models.qwen2_5_vl import convert as jconv
from glimpseprune_tpu.preprocessing import build_vision_geometry, get_rope_index

HF_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_model_parity.py's


@functools.lru_cache(maxsize=None)
def hf_model(tied: bool = False):
    import torch
    from transformers import Qwen2_5_VLForConditionalGeneration
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import Qwen2_5_VLConfig

    torch.manual_seed(0)
    cfg = Qwen2_5_VLConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-6, rope_theta=1e6,
        vision_config=dict(depth=4, hidden_size=32, num_heads=4, intermediate_size=64,
                           patch_size=14, window_size=56, spatial_merge_size=2,
                           temporal_patch_size=2, fullatt_block_indexes=[3],
                           out_hidden_size=64),
        image_token_id=500, video_token_id=501, vision_start_token_id=498,
        vision_end_token_id=499, rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        tie_word_embeddings=tied)
    return Qwen2_5_VLForConditionalGeneration(cfg).eval(), cfg


def old_layout(sd):
    """The pre-4.50 key layout: visual.*, model.layers.*, model.embed_tokens.*."""
    out = {}
    for k, v in sd.items():
        for new, old in (("model.visual.", "visual."), ("model.language_model.", "model.")):
            if k.startswith(new):
                k = old + k[len(new):]
                break
        out[k] = v
    return out


@pytest.mark.parametrize("layout,head", [("new", "untied"), ("old", "untied"),
                                         ("new", "tied"), ("old", "headless")])
def test_converted_weights_equal_jax(layout, head):
    """'tied' is a tied config (no head); 'headless' an untied config over a
    checkpoint without lm_head.weight, whose head is the embedding."""
    import torch

    from glimpseprune_torch.convert import params_from_jax
    from glimpseprune_torch.models.qwen2_5_vl import convert as tconv

    model, hf_cfg = hf_model(tied=head == "tied")
    sd = model.state_dict()
    if layout == "old":
        sd = old_layout(sd)
    if head == "headless":
        sd = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    cfg_t = tconv.hf_config_to_model_config(hf_cfg)
    cfg_j = jconv.hf_config_to_model_config(hf_cfg)
    got = tconv.convert_hf_state_dict(sd, cfg_t)
    want = params_from_jax(jconv.convert_hf_state_dict(sd, cfg_j), cfg_j)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert ("text.lm_head.weight" in got) == (head != "tied")
    if head == "headless":
        assert torch.equal(got["text.lm_head.weight"], got["text.embed_tokens.weight"])


def test_hf_config_to_model_config_equals_jax():
    """From the config object and from its config.json dict (a mapping,
    no transformers), tied and untied."""
    from glimpseprune_torch.models.qwen2_5_vl import convert as tconv

    for tied in (False, True):
        _, hf_cfg = hf_model(tied)
        want = dataclasses.asdict(jconv.hf_config_to_model_config(hf_cfg, reduce_layer=2))
        as_dict = json.loads(json.dumps(hf_cfg.to_dict()))
        for src in (hf_cfg, as_dict):
            got = tconv.hf_config_to_model_config(src, reduce_layer=2)
            assert dataclasses.asdict(got) == want
        flat = {**{k: v for k, v in as_dict.items() if k != "text_config"},
                **as_dict["text_config"]}  # the text fields at the top level
        assert dataclasses.asdict(tconv.hf_config_to_model_config(flat, reduce_layer=2)) == want
    with pytest.raises(KeyError, match="depth"):
        tconv.hf_config_to_model_config({**as_dict, "vision_config": {}})


@functools.lru_cache(maxsize=None)
def port_model():
    """The port's model on the converted untied weights (fp32, CPU); the
    GlimpsePrune modules drawn around them."""
    import torch

    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl import convert as tconv

    model, hf_cfg = hf_model()
    gp = dataclasses.asdict(tiny_test_config().gp)  # GPConfig()'s fuser reads no layer
    cfg = tconv.hf_config_to_model_config(hf_cfg, **gp)
    state = tconv.convert_hf_state_dict(model.state_dict(), cfg)
    return init_random(cfg, 0, "cpu", torch.float32, base=state), cfg


def test_vision_forward_matches_hf():
    import torch

    hf, _ = hf_model()
    model, cfg = port_model()
    rng = np.random.default_rng(0)
    grids = np.array([[1, 6, 8], [1, 4, 4]])
    patches = rng.normal(size=(int(np.prod(grids, 1).sum()), 3 * 2 * 14 * 14)).astype(np.float32)
    with torch.no_grad():
        want = hf.model.visual(torch.as_tensor(patches), grid_thw=torch.as_tensor(grids)).numpy()
    geo = build_vision_geometry(grids, window_size=56, spatial_merge_size=2, patch_size=14)
    win = np.zeros((geo.padded_len, patches.shape[1]), dtype=np.float32)
    win[geo.patch_valid] = patches[geo.patch_src[geo.patch_valid]]
    with torch.no_grad():
        merged, _ = model.visual(torch.as_tensor(win), torch.as_tensor(geo.pos_ids),
                                 torch.as_tensor(geo.full_segment_ids),
                                 torch.as_tensor(geo.patch_valid))
    np.testing.assert_allclose(merged.numpy()[geo.slot_of_merged], want, **HF_TOL)


def test_text_forward_matches_hf():
    """Full-prefill logits on left-padded rows, valid positions only."""
    import torch

    hf, _ = hf_model()
    model, cfg = port_model()
    rng = np.random.default_rng(1)
    ids = rng.integers(5, 400, size=(2, 12))
    mask = np.ones((2, 12), dtype=np.int64)
    mask[0, :3] = 0
    pos, _ = get_rope_index(ids, None, None, mask)
    with torch.no_grad():
        want = hf(input_ids=torch.as_tensor(ids), attention_mask=torch.as_tensor(mask),
                  position_ids=torch.as_tensor(pos)).logits.numpy()
        got = model.text_prefill_logits(torch.as_tensor(ids), torch.as_tensor(mask, dtype=bool),
                                        torch.as_tensor(pos)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], **HF_TOL)

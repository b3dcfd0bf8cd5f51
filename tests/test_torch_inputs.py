"""The port's host prep (glimpseprune_torch/models/qwen2_5_vl/inputs.py) is
a numpy copy of the JAX package's; it must produce the same arrays, field by
field. Also the shared tiny setup of the tests/test_torch_*.py parity tests:
the same prompts, images and weights for the JAX package and the port.

These files import torch and the port inside the tests, as the repo's other
torch-using tests do: a test worker that never runs them then does not
carry torch's objects, whose full garbage collections (~70 ms) stall the
thread-timed tests that share the worker."""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.config import tiny_test_config
from glimpseprune_tpu.gp import fuser as jax_fuser
from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from glimpseprune_tpu.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP


def make_batch_args(cfg, seed=0, with_answers=False):
    """Two single-image rows of different image sizes and prompt lengths,
    as in __graft_entry__._make_setup."""
    rng = np.random.default_rng(seed)
    prompts, answers = [], []
    for n_tail in (3, 6):
        prompts.append(
            [int(x) for x in rng.integers(5, 400, 4)]
            + [cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id]
            + [int(x) for x in rng.integers(5, 400, n_tail)])
        answers.append([int(x) for x in rng.integers(5, 400, 4)])
    images = [rng.integers(0, 255, (64, 96, 3), dtype=np.uint8),
              rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    kwargs = dict(seq_multiple=8, patch_multiple=16)
    if with_answers:
        kwargs.update(normed_bboxes=[[[0.0, 0.0, 0.5, 1.0]], [[0.5, 0.5, 1.0, 1.0]]],
                      answer_ids=answers)
    return prompts, images, kwargs


def jax_batch(prep):
    return [jnp.asarray(a) for a in (
        prep.input_ids, prep.valid, prep.position_ids, prep.patches, prep.vis_pos_ids,
        prep.full_seg, prep.vis_valid, prep.packed_idx, prep.img_slots, prep.img_valid,
        prep.fuser.window_index, prep.fuser.reverse_index, prep.fuser.segment_ids,
        prep.fuser.pos_ids, prep.le_start)]


def random_params(jmodel, prep, seed):
    """Numpy weights in the JAX params' shapes (taken from an abstract
    init, which compiles nothing): matrices normal / sqrt(fan_in), biases
    and norm scales perturbed away from 0 and 1 so they are exercised."""
    shapes = jax.eval_shape(lambda key, *a: jmodel.init(key, *a, prep.out_len),
                            jax.random.PRNGKey(0), *jax_batch(prep))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("['kernel']"):
            return x / np.float32(np.sqrt(s.shape[-2]))
        if name.endswith("['bias']"):
            return 0.1 * x
        if name.endswith("['weight']"):  # norm scales
            return 1.0 + 0.1 * x
        return x  # token and glimpse embeddings

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def make_setup(seed: int = 0):
    """Tiny config, one inference batch prepared by both packages, random
    JAX params, and the port's model holding the same weights (fp32 on the
    CPU)."""
    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.models.qwen2_5_vl import inputs as torch_inputs

    cfg = tiny_test_config()
    prompts, images, kwargs = make_batch_args(cfg, seed)
    prep_j = jax_runner.prepare_inputs(cfg, prompts, images, **kwargs)
    prep_t = torch_inputs.prepare_inputs(cfg, prompts, images, **kwargs)
    jmodel = Qwen2_5_VL_GP(cfg)
    params = random_params(jmodel, prep_j, seed)
    tmodel = load_from_jax(params, cfg)
    return SimpleNamespace(cfg=cfg, jmodel=jmodel, params=params, prep_j=prep_j,
                           prep_t=prep_t, tmodel=tmodel)


def assert_same_fields(a, b, path=""):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        fa = {f.name for f in dataclasses.fields(a)}
        assert fa == {f.name for f in dataclasses.fields(b)}, path
        for name in sorted(fa):
            assert_same_fields(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("with_answers", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_inputs_equals_jax(with_answers, seed):
    from glimpseprune_torch.models.qwen2_5_vl import inputs as torch_inputs

    cfg = tiny_test_config()
    prompts, images, kwargs = make_batch_args(cfg, seed, with_answers)
    want = jax_runner.prepare_inputs(cfg, prompts, images, **kwargs)
    got = torch_inputs.prepare_inputs(cfg, prompts, images, **kwargs)
    assert_same_fields(want, got)
    assert torch_inputs._vis_dense_hint(got) == jax_runner._vis_dense_hint(want)


@pytest.mark.parametrize("attn_fuse_global", [False, True])
def test_build_fuser_geometry_equals_jax(attn_fuse_global):
    from glimpseprune_torch.models.qwen2_5_vl import inputs as torch_inputs

    grids = [(4, 6), (2, 2), [(3, 5), (4, 4)]]
    want = jax_fuser.build_fuser_geometry(grids, 40, 56, 2, 14, attn_fuse_global)
    got = torch_inputs.build_fuser_geometry(grids, 40, 56, 2, 14, attn_fuse_global)
    assert_same_fields(want, got)


def test_dense_hint_single_unpadded_image():
    from glimpseprune_torch.models.qwen2_5_vl import inputs as torch_inputs

    cfg = tiny_test_config()
    rng = np.random.default_rng(3)
    prompt = [7, cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id, 9]
    image = rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)
    want = jax_runner.prepare_inputs(cfg, [prompt], [image], patch_multiple=16)
    got = torch_inputs.prepare_inputs(cfg, [prompt], [image], patch_multiple=16)
    assert_same_fields(want, got)
    assert torch_inputs._vis_dense_hint(got) and jax_runner._vis_dense_hint(want)


def test_setup_weights_round_trip():
    """Every JAX parameter lands in the port's model, and nothing else."""
    import torch

    s = make_setup()
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(s.params))
    n_torch = sum(p.numel() for p in s.tmodel.parameters())
    assert n_jax == n_torch
    np.testing.assert_array_equal(
        s.tmodel.text.lm_head.weight.numpy(), s.params["text"]["lm_head"]["kernel"].T)
    np.testing.assert_array_equal(
        s.tmodel.visual.blocks[2].attn.qkv.weight.numpy(),
        s.params["visual"]["blocks"]["attn"]["qkv"]["kernel"][2].T)
    assert s.tmodel.text.embed_tokens.weight.dtype == torch.float32


def test_init_random_scales_and_seed():
    """init_random: deterministic per seed, the JAX init's scales."""
    import torch

    from glimpseprune_torch.convert import init_random

    cfg = tiny_test_config()
    a = init_random(cfg, seed=3, device="cpu", dtype=torch.float32)
    b = init_random(cfg, seed=3, device="cpu", dtype=torch.float32)
    c = init_random(cfg, seed=4, device="cpu", dtype=torch.float32)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.text.lm_head.weight, c.text.lm_head.weight)
    assert torch.equal(a.text.norm.weight, torch.ones(cfg.text.hidden_size))
    assert torch.equal(a.visual.blocks[0].attn.qkv.bias, torch.zeros(3 * cfg.vision.hidden_size))
    w = a.text.layers[0].mlp.down_proj.weight  # [out, in]: std 1/sqrt(fan_in)
    assert abs(w.std().item() * cfg.text.intermediate_size ** 0.5 - 1.0) < 0.1
    assert abs(a.learnable_embeddings.std().item() - 0.02) < 0.005
    assert not any(p.requires_grad for p in a.parameters())

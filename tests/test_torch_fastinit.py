"""The port's fast random weights (glimpseprune_torch/utils/fastinit.py)
against the JAX package's (glimpseprune_tpu/utils/fastinit.py):
``fast_random_params`` on the tiny config in fp, int8 and int4 gives the
JAX tree's bytes at the same seed (before and after ``params_from_jax``);
the port's greedy tokens on those weights equal JAX's; and
``device_random_params`` on the CPU follows the law within 5% and holds no
float copy of a quantized linear."""

import numpy as np
import pytest

import jax

from glimpseprune_tpu.config import tiny_test_config
from glimpseprune_tpu.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
from glimpseprune_tpu.quantization import quantized_config
from glimpseprune_tpu.utils.fastinit import fast_random_params as jax_fast_random_params
from test_torch_inputs import jax_batch, make_batch_args


def _cfg(mode):
    cfg = tiny_test_config()
    return quantized_config(cfg, mode) if mode else cfg


def _jax_tree(cfg, seed):
    from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner

    prompts, images, kwargs = make_batch_args(cfg)
    prep = jax_runner.prepare_inputs(cfg, prompts, images, **kwargs)
    args = (jax.random.PRNGKey(0), *jax_batch(prep))
    return jax_fast_random_params(Qwen2_5_VL_GP(cfg), args, prep.out_len, seed=seed)


@pytest.mark.parametrize("mode", ["", "int8", "int4"])
def test_fast_random_params_bytes_equal_jax(mode):
    from glimpseprune_torch.convert import params_from_jax
    from glimpseprune_torch.utils.fastinit import fast_random_params

    cfg = _cfg(mode)
    want = _jax_tree(cfg, seed=7)
    got = fast_random_params(cfg, seed=7)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path
    sd_w, sd_g = params_from_jax(want, cfg), params_from_jax(got, cfg)
    assert sd_w.keys() == sd_g.keys()
    for k in sd_w:
        assert sd_w[k].dtype == sd_g[k].dtype and np.array_equal(sd_w[k].numpy(),
                                                                 sd_g[k].numpy()), k


def test_fast_random_params_greedy_tokens_equal_jax():
    from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner

    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.models.qwen2_5_vl import inputs as torch_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.utils.fastinit import fast_random_params

    cfg = _cfg("")
    prompts, images, kwargs = make_batch_args(cfg)
    want = jax_runner.GlimpsePruneRunner(cfg, _jax_tree(cfg, seed=3)).generate(
        jax_runner.prepare_inputs(cfg, prompts, images, **kwargs), max_new_tokens=8)
    model = load_from_jax(fast_random_params(cfg, seed=3), cfg, device="cpu")
    got = GlimpsePruneRunner(cfg, model).generate(
        torch_inputs.prepare_inputs(cfg, prompts, images, **kwargs), max_new_tokens=8)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.keep_img, want.keep_img)


@pytest.mark.parametrize("mode", ["", "int8", "int4"])
def test_device_random_params_law(mode):
    """The host law drawn by a torch.Generator: kernels (dequantized) with
    std fan_in ** -0.5 within 5%, biases 0, norms 1; a quantized linear
    holds its int8 buffer and fp32 scales, no float weight; the model's
    tensors are those the JAX tree loads into, the int8 ones in the same
    memory order."""
    import torch

    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.models.layers import QuantLinear
    from glimpseprune_torch.utils.fastinit import device_random_params, fast_random_params

    cfg = _cfg(mode)
    model = device_random_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    ref = load_from_jax(fast_random_params(cfg, seed=1), cfg, device="cpu")
    got_sd, ref_sd = model.state_dict(), ref.state_dict()
    assert got_sd.keys() == ref_sd.keys()
    for k in ref_sd:
        assert got_sd[k].shape == ref_sd[k].shape and got_sd[k].dtype == ref_sd[k].dtype, k
        if ref_sd[k].dtype == torch.int8:  # the kernels' memory order (QuantLinear)
            assert got_sd[k].stride() == ref_sd[k].stride(), k
    n_quant = 0
    for name, mod in model.named_modules():
        if isinstance(mod, QuantLinear):
            n_quant += 1
            floats = [t for t in list(mod.parameters()) + list(mod.buffers())
                      if t.is_floating_point() and t.numel() >= mod.in_features]
            assert all(t.dtype == torch.float32 and t.numel() < mod.in_features *
                       mod.out_features for t in floats), name
            if mod.mode == "int8":
                w = mod.kernel_q.float() * mod.kernel_scale
                assert int(mod.kernel_q.abs().max()) <= 127
            else:
                packed = mod.kernel_q4
                q = torch.cat([(packed << 4) >> 4, packed >> 4], 0).float()
                assert int(q.abs().max()) <= 7
                w = q * mod.kernel_scale4.mean()
            want = mod.in_features ** -0.5
            assert abs(float(w.std()) / want - 1) < 0.05, (name, float(w.std()), want)
        elif isinstance(mod, torch.nn.Linear) and mod.weight.shape[1] >= 32 \
                and mod.weight.numel() >= 2048:
            want = mod.weight.shape[1] ** -0.5
            assert abs(float(mod.weight.std()) / want - 1) < 0.05, name
            if mod.bias is not None:
                assert not mod.bias.any(), name
    assert (n_quant > 0) == bool(mode)
    assert bool((model.text.norm.weight == 1).all())

"""The port's quantization (glimpseprune_torch/quantization.py) against the
JAX package's: byte-identical int8 and int4 weights and equal scales from
the same array, the int4 tier's int8 fallback, dequantization, the W8A8
product, quantized_config, and the weight bridge for a quantized JAX tree.
Inputs come from a numpy seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu import quantization as jq
from glimpseprune_tpu.config import tiny_test_config


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _jax_leaf(tree_fn, w, **kw):
    return tree_fn({"text": {"layers": {"mlp": {"up_proj": {"kernel": jnp.asarray(w)}}}}},
                   **kw)["text"]["layers"]["mlp"]["up_proj"]


@pytest.mark.parametrize("shape", [(256, 96), (3, 128, 40)])
def test_quantize_int8_bytes_equal_jax(shape):
    import torch

    from glimpseprune_torch import quantization as tq

    w = _weights(shape, 0)
    want = _jax_leaf(jq.quantize_int8, w)
    got = tq.quantize_int8(torch.as_tensor(w))
    np.testing.assert_array_equal(got["kernel_q"].numpy(), np.asarray(want["kernel_q"]))
    np.testing.assert_array_equal(got["kernel_scale"].numpy(), np.asarray(want["kernel_scale"]))
    assert got["kernel_q"].dtype == torch.int8 and got["kernel_scale"].dtype == torch.float32


@pytest.mark.parametrize("shape,keys", [
    ((256, 96), ("kernel_q4", "kernel_scale4")),      # group 64
    ((2, 96, 64), ("kernel_q4", "kernel_scale4")),    # group 16, stacked
    ((1176, 40), ("kernel_q", "kernel_scale")),       # the int8 fallback
])
def test_quantize_int4_bytes_equal_jax(shape, keys):
    import torch

    from glimpseprune_torch import quantization as tq

    w = _weights(shape, 1)
    want = _jax_leaf(jq.quantize_int4, w)
    got = tq.quantize_int4(torch.as_tensor(w))
    assert tuple(sorted(got)) == tuple(sorted(want)) == tuple(sorted(keys))
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert tq._int4_group(shape[-2]) == jq._int4_group(shape[-2])


def test_dequantize_matches_jax():
    """fp32 dequantization: the same values from the same bytes."""
    import torch

    from glimpseprune_torch import quantization as tq

    w = _weights((256, 64), 2)
    leaf4 = _jax_leaf(jq.quantize_int4, w)
    want = np.asarray(jq.dequant_int4(leaf4, jnp.float32))
    got = tq.dequant_int4(torch.as_tensor(np.asarray(leaf4["kernel_q4"])),
                          torch.as_tensor(np.asarray(leaf4["kernel_scale4"])), torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    leaf8 = _jax_leaf(jq.quantize_int8, w)
    want8 = np.asarray(jq.dequantize_int8(
        {"k": {"kernel_q": leaf8["kernel_q"], "kernel_scale": leaf8["kernel_scale"]}},
        jnp.float32)["k"]["kernel"])
    got8 = tq.dequantize_int8(torch.as_tensor(np.asarray(leaf8["kernel_q"])),
                              torch.as_tensor(np.asarray(leaf8["kernel_scale"])), torch.float32)
    np.testing.assert_array_equal(got8.numpy(), want8)


@pytest.mark.parametrize("lead", [(5,), (2, 9)])
def test_matmul_w8a8_matches_jax(lead):
    """Both packages quantize the rows identically and sum exactly in int32;
    the only difference is fp32 rounding of the rescale (1e-6 relative)."""
    import torch

    from glimpseprune_torch import quantization as tq

    w = _weights((96, 40), 3)
    leaf = _jax_leaf(jq.quantize_int8, w)
    x = np.random.default_rng(4).standard_normal(lead + (96,)).astype(np.float32)
    want = np.asarray(jq.matmul_w8a8(jnp.asarray(x), leaf["kernel_q"], leaf["kernel_scale"],
                                     jnp.float32))
    got = tq.matmul_w8a8(torch.as_tensor(x), torch.as_tensor(np.asarray(leaf["kernel_q"])),
                         torch.as_tensor(np.asarray(leaf["kernel_scale"])), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kwargs", [
    dict(mode="int8"),
    dict(mode="int4", act_quant="prefill", attn_qk_int8="vision", attn_pv_int8="vision"),
    dict(mode="int8", act_quant="int8", attn_qk_int8=True),
    dict(mode="int4", act_quant="prefill", attn_qk_int8="both", attn_pv_int8="text"),
])
def test_quantized_config_matches_jax(kwargs):
    from glimpseprune_torch import config as tc
    from glimpseprune_torch import quantization as tq

    want = jq.quantized_config(tiny_test_config(), **kwargs)
    got = tq.quantized_config(tc.tiny_test_config(), **kwargs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_quantized_config_refuses_like_jax():
    from glimpseprune_torch import config as tc
    from glimpseprune_torch import quantization as tq

    for fn, cfg in ((jq.quantized_config, tiny_test_config()),
                    (tq.quantized_config, tc.tiny_test_config())):
        with pytest.raises(ValueError):
            fn(cfg, "int8", act_quant="prefill", attn_qk_int8="gpu")
        with pytest.raises(ValueError):
            fn(cfg, "int8", act_quant="all")
        with pytest.raises(AssertionError):
            fn(cfg, "int8", attn_qk_int8=True)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_params_from_jax_maps_quantized_tree(mode):
    """A quantized JAX tree lands in QuantLinear buffers byte for byte,
    stacked layers split per layer, everything else as in the bf16 bridge;
    init_random's quantize_model gives the same buffer names."""
    import torch

    from glimpseprune_torch import quantization as tq
    from glimpseprune_torch.config import tiny_test_config as torch_tiny
    from glimpseprune_torch.convert import init_random, load_from_jax
    from glimpseprune_torch.models.layers import QuantLinear
    from test_torch_inputs import make_setup

    s = make_setup()
    qparams = (jq.quantize_int8 if mode == "int8" else jq.quantize_int4)(s.params)
    qcfg = tq.quantized_config(torch_tiny(), mode)
    model = load_from_jax(qparams, qcfg, device="cpu")
    key = "kernel_q" if mode == "int8" else "kernel_q4"
    stacked = qparams["text"]["layers"]["self_attn"]["q_proj"]
    for layer in range(qcfg.text.num_hidden_layers):
        lin = model.text.layers[layer].self_attn.q_proj
        assert isinstance(lin, QuantLinear) and lin.mode == mode
        np.testing.assert_array_equal(getattr(lin, key).numpy(), np.asarray(stacked[key])[layer])
        np.testing.assert_array_equal(lin.bias.numpy(), np.asarray(stacked["bias"])[layer])
    head = qparams["text"]["lm_head"]
    np.testing.assert_array_equal(getattr(model.text.lm_head, key).numpy(), np.asarray(head[key]))
    scale = model.text.lm_head.kernel_scale if mode == "int8" else model.text.lm_head.kernel_scale4
    assert scale.dtype == torch.float32
    np.testing.assert_array_equal(model.visual.patch_embed.weight.numpy(),
                                  np.asarray(qparams["visual"]["patch_embed"]["kernel"]).T)
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(qparams))
    n_torch = sum(t.numel() for t in list(model.parameters()) + list(model.buffers()))
    assert n_jax == n_torch
    rnd = init_random(qcfg, seed=0, device="cpu", dtype=torch.float32)
    assert set(rnd.state_dict()) == set(model.state_dict())
    assert tq.quantized_bytes(model) == sum(
        np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(qparams))

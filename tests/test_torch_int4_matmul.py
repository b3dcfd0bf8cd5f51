"""The plain versions of K4, K5 and K6 (glimpseprune_torch/ops/cuda/
int4_matmul.py) against the JAX package's Pallas kernels in interpret mode
on the same numpy-seeded weights, and the routing gates against JAX's over
the 7B and tiny shapes. The CUDA kernels are held to these plain versions
on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest

import glimpseprune_tpu.ops.pallas.int4_matmul as jm4
from glimpseprune_tpu import quantization as jq

K, N = 1024, 512


def _packed(seed, k=K, n=N):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    tree = jq.quantize_int4({"text": {"layers": {"l0": {"kernel": jnp.asarray(w)}}}})
    leaf = tree["text"]["layers"]["l0"]
    return np.asarray(leaf["kernel_q4"]), np.asarray(leaf["kernel_scale4"])


def _x(m, seed, k=K):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)


@pytest.mark.parametrize("m", [1, 2, 16])
def test_k4_plain_matches_pallas(m):
    """fp32 on both sides: only the summation order differs (1e-5)."""
    import torch

    from glimpseprune_torch.ops.cuda import int4_matmul as tm4

    packed, scales = _packed(0)
    x = _x(m, m)
    want = np.asarray(jm4.matmul_int4(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
                                      out_dtype=jnp.float32, interpret=True))
    got = tm4.matmul_int4(torch.as_tensor(x), torch.as_tensor(packed),
                          torch.as_tensor(scales), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [160, 512])
def test_k5_plain_matches_pallas(m):
    """W4A16: fp32 weights times group scales, fp32 products (1e-4)."""
    import torch

    from glimpseprune_torch.ops.cuda import int4_matmul as tm4

    packed, scales = _packed(1)
    x = _x(m, 10 + m)
    want = np.asarray(jm4.matmul_int4_prefill(jnp.asarray(x), jnp.asarray(packed),
                                              jnp.asarray(scales), out_dtype=jnp.float32,
                                              a8=False, interpret=True))
    got = tm4.matmul_int4_prefill(torch.as_tensor(x), torch.as_tensor(packed),
                                  torch.as_tensor(scales), out_dtype=torch.float32, a8=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m", [160, 512])
def test_k6_plain_matches_pallas(m):
    """W4A8: the same int8 activations and requantized int8 weights, exact
    int32 sums; the rescale's fp32 rounding is the only difference (1e-6
    relative)."""
    import torch

    from glimpseprune_torch.ops.cuda import int4_matmul as tm4

    packed, scales = _packed(2)
    x = _x(m, 20 + m)
    want = np.asarray(jm4.matmul_int4_prefill(jnp.asarray(x), jnp.asarray(packed),
                                              jnp.asarray(scales), out_dtype=jnp.float32,
                                              a8=True, interpret=True))
    got = tm4.matmul_int4_prefill(torch.as_tensor(x), torch.as_tensor(packed),
                                  torch.as_tensor(scales), out_dtype=torch.float32, a8=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the requantized weights are bit-identical to the JAX recipe's
    s8, r = tm4.requant_ratios(torch.as_tensor(scales))
    s8_j = np.maximum(scales.max(axis=0, keepdims=True), 1e-12) * np.float32(7.0 / 127.0)
    np.testing.assert_array_equal(s8.numpy(), s8_j)
    np.testing.assert_array_equal(r.numpy(), scales / s8_j)


SHAPES = [
    # (M, K, N, g): 7B decode and prefill, the head, the ViT, the tiny config
    (1, 3584, 3584, 64), (2, 3584, 512, 64), (2, 3584, 18944, 64), (2, 18944, 3584, 64),
    (2, 3584, 152064, 64), (128, 3584, 3584, 64), (129, 3584, 3584, 64),
    (1664, 3584, 18944, 64), (1664, 18944, 3584, 64), (1664, 3584, 512, 64),
    (5120, 1280, 3840, 64), (5120, 1280, 3420, 64), (5120, 1280, 1280, 64),
    (16384, 5120, 3584, 64), (512, 3584, 152064, 64), (2, 64, 128, 32), (40, 128, 64, 32),
    (300, 64, 512, 32), (1, 1176, 512, 64), (4096, 512, 500, 64), (1, 512, 512, 32),
]


@pytest.mark.parametrize("m,k,n,g", SHAPES)
def test_gates_equal_jax(m, k, n, g):
    from glimpseprune_torch.ops.cuda import int4_matmul as tm4

    assert tm4.kernel_applicable(m, k, n, g) == jm4.kernel_applicable(m, k, n, g)
    assert tm4.prefill_applicable(m, k, n, g) == jm4.prefill_applicable(m, k, n, g)
    for a8 in (False, True):
        assert tm4.prefill_routable(m, k, n, g, a8) == jm4.prefill_routable(m, k, n, g, a8)


@pytest.mark.parametrize("m,a8", [(3, False), (192, True), (192, False)])
def test_auto_routing_matches_jax(m, a8):
    """matmul_int4_auto takes K4, K6 or dequantize-then-matmul on the same
    shapes as the JAX package's with its kernels in interpret mode."""
    import torch

    from glimpseprune_torch import quantization as tq

    packed, scales = _packed(3)
    x = _x(m, 30 + m)
    old = jm4.INT4_MATMUL_IMPL
    try:
        jm4.INT4_MATMUL_IMPL = "pallas_interpret"
        want = np.asarray(jq.matmul_int4_auto(
            jnp.asarray(x), {"kernel_q4": jnp.asarray(packed),
                             "kernel_scale4": jnp.asarray(scales)}, jnp.float32, a8=a8))
    finally:
        jm4.INT4_MATMUL_IMPL = old
    got = tq.matmul_int4_auto(torch.as_tensor(x), torch.as_tensor(packed),
                              torch.as_tensor(scales), torch.float32, a8=a8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_wrappers_refuse_shapes_off_their_gate():
    import torch

    from glimpseprune_torch.ops.cuda import int4_matmul as tm4

    packed, scales = _packed(4)
    with pytest.raises(ValueError):
        tm4.matmul_int4(torch.zeros((200, K)), torch.as_tensor(packed), torch.as_tensor(scales))
    with pytest.raises(ValueError):
        tm4.matmul_int4_prefill(torch.zeros((8, K)), torch.as_tensor(packed),
                                torch.as_tensor(scales))
    # K4's split of K: whole packed groups over the blocks of one cluster
    plan = tm4.plan_int4_decode(2, 3584, 512)
    assert (plan.ksplit, plan.groups_per_split) == (7, 4)
    plan = tm4.plan_int4_decode(2, 3584, 152064)
    assert (plan.ksplit, plan.groups_per_split) == (1, 28)
    plan = tm4.plan_int4_decode(2, 18944, 3584)
    ks, per = plan.ksplit, plan.groups_per_split
    assert ks * per >= 18944 // 2 // 64 and (ks - 1) * per < 18944 // 2 // 64 and ks <= 8

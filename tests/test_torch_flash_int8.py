"""The plain version of K7, the int8 flavour of flash attention
(glimpseprune_torch/ops/cuda/flash_attention.py), against the JAX package's
Pallas kernel in interpret mode (``qkv_int8=True``, with and without
``pv_int8``) on the same numpy-seeded inputs, segmented, dense and causal.
Both sides get the same explicit kv tile (``block_k``), over which the
pv_int8 tier quantizes v. chip_smoke.py holds the CUDA kernel to this plain
version at the kernel's own tile."""

import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash

# fp32 on both sides from the same int8 q and k: the int32 scores are exact
# and the rescale rounds identically, so only exp2 and the summation order
# differ (1e-5). Under pv_int8, p * 127 is rounded to an integer: an exp2
# ulp apart can flip one rounding, which moves an output by at most
# v_scale / 127 / l (2e-4 here).
TOL = dict(atol=1e-5, rtol=1e-5)
TOL_PV = dict(atol=2e-4, rtol=1e-4)


def _case(case, rng, b=2, s=256):
    if case == "dense":
        return None
    seg = np.zeros((b, s), np.int32)
    if case == "causal":  # left-padded rows
        for i, n_pad in enumerate((17, 90)):
            seg[i, :n_pad] = -1
    else:  # two images and a padding tail
        seg[:, 100:] = 1
        seg[:, -30:] = -1
    return seg


@pytest.mark.parametrize("pv", [False, True])
@pytest.mark.parametrize("case,d", [("segmented", 80), ("dense", 80), ("causal", 64)])
def test_int8_plain_matches_pallas(case, d, pv):
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import flash_attention

    rng = np.random.default_rng(3)
    b, hq, hkv, s = 2, 4, 2, 256
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    seg = _case(case, rng, b, s)
    causal, dense = case == "causal", case == "dense"
    jseg = None if dense else jnp.asarray(seg)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg, jseg,
                                   causal=causal, dense=dense, block_q=128, block_k=128,
                                   interpret=True, qkv_int8=True, pv_int8=pv))
    tseg = None if dense else torch.as_tensor(seg)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), tseg,
                          tseg, causal=causal, dense=dense, qkv_int8=True, pv_int8=pv,
                          block_k=128).numpy()
    rows = np.ones((b, s), bool) if dense else seg >= 0
    mask = np.broadcast_to(rows[:, None], (b, hq, s))
    np.testing.assert_allclose(got[mask], want[mask], **(TOL_PV if pv else TOL))
    if not dense:  # a row with no allowed key is zero, as in the kernel
        assert np.abs(got.transpose(0, 2, 1, 3)[~rows]).max() == 0.0


def test_int8_default_tile_is_jax_default():
    """Without block_k the CPU path takes the JAX package's default tile
    (2048 when the kv length divides it, else 1024): pv_int8 results then
    match the JAX default call."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import default_block_k, flash_attention

    assert default_block_k(4096) == 2048 and default_block_k(1100) == 1024
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 2, 1100, 32)).astype(np.float32)
    k = rng.standard_normal((1, 1, 1100, 32)).astype(np.float32)
    v = rng.standard_normal((1, 1, 1100, 32)).astype(np.float32)
    seg = np.zeros((1, 1100), np.int32)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(seg), jnp.asarray(seg), block_q=512,
                                   interpret=True, qkv_int8=True, pv_int8=True))
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                          torch.as_tensor(seg), torch.as_tensor(seg), qkv_int8=True,
                          pv_int8=True).numpy()
    np.testing.assert_allclose(got, want, **TOL_PV)


def test_int8_quant_rows_and_refusals():
    """Per-row q/k quantization (the port's one per-row quantizer,
    kv_cache.quantize_kv) equals JAX's _quant_rows_i8; the tier is inference
    only, and pv_int8 needs qkv_int8."""
    import torch

    from glimpseprune_tpu.ops.pallas.flash_attention import _quant_rows_i8
    from glimpseprune_torch.ops.cuda.flash_attention import flash_attention
    from glimpseprune_torch.ops.kv_cache import quantize_kv

    x = np.random.default_rng(9).standard_normal((2, 3, 40, 24)).astype(np.float32)
    qi_j, sc_j = _quant_rows_i8(jnp.asarray(x))
    qi_t, sc_t = quantize_kv(torch.as_tensor(x))
    np.testing.assert_array_equal(qi_t.numpy(), np.asarray(qi_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    t = torch.as_tensor(x[:, :2]).requires_grad_(True)
    with pytest.raises(ValueError, match="inference only"):
        flash_attention(t, t, t, dense=True, qkv_int8=True)
    with pytest.raises(ValueError, match="pv_int8"):
        flash_attention(t.detach(), t.detach(), t.detach(), dense=True, pv_int8=True)

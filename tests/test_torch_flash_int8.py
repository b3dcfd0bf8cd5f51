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

from glimpseprune_tpu.ops.pallas.flash_attention import _quant_rows_i8
from glimpseprune_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
from glimpseprune_torch.ops.cuda.flash_attention import KERNEL_BLOCK_K

# fp32 on both sides from the same int8 q and k: the int32 scores are exact
# and the rescale rounds identically, so only exp2 and the summation order
# differ (1e-5). Under pv_int8, p * 127 is rounded to an integer: an exp2
# ulp apart can flip one rounding, which moves an output by at most
# v_scale / 127 / l (2e-4 here).
TOL = dict(atol=1e-5, rtol=1e-5)
TOL_PV = dict(atol=2e-4, rtol=1e-4)
# At the kernel's tile of 64 keys a row's probabilities are rounded against
# twice as many running maxima, and the dense case meets one flip whose row
# has a smaller l: 2.7e-4 on one of its 2048 rows (the other 2047 within
# 1e-5). 4e-4 bounds one flip there; the 128-key cases keep TOL_PV.
TOL_PV_KERNEL_TILE = dict(atol=4e-4, rtol=1e-4)


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


# the kernel's own kv tile (KERNEL_BLOCK_K), beside the 128 of the first cases
_CASES = [pytest.param(case, d, bk, id=f"{case}-{d}" + ("" if bk == 128 else f"-bk{bk}"))
          for bk in (128, KERNEL_BLOCK_K)
          for case, d in (("segmented", 80), ("dense", 80), ("causal", 64))]


@pytest.mark.parametrize("pv", [False, True])
@pytest.mark.parametrize("case,d,block_k", _CASES)
def test_int8_plain_matches_pallas(case, d, block_k, pv):
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
                                   causal=causal, dense=dense, block_q=128, block_k=block_k,
                                   interpret=True, qkv_int8=True, pv_int8=pv))
    tseg = None if dense else torch.as_tensor(seg)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), tseg,
                          tseg, causal=causal, dense=dense, qkv_int8=True, pv_int8=pv,
                          block_k=block_k).numpy()
    rows = np.ones((b, s), bool) if dense else seg >= 0
    mask = np.broadcast_to(rows[:, None], (b, hq, s))
    tol_pv = TOL_PV if block_k == 128 else TOL_PV_KERNEL_TILE
    np.testing.assert_allclose(got[mask], want[mask], **(tol_pv if pv else TOL))
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


@pytest.mark.parametrize("case", ["dense", "segmented"])
def test_int8_p_rounded_to_v_dtype(case):
    """Without pv_int8 the Pallas kernel rounds P to v's dtype before the PV
    dot (:157-160), and so do the plain version and the kernel: with a bf16
    v the plain version stays within an exp2 ulp's flip of one bf16 rounding
    of p (1e-4) of Pallas, where the unrounded P product is 6e-4 away."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import flash_attention

    rng = np.random.default_rng(3)
    b, h, s, d = 1, 2, 256, 80
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, h, s, d)).astype(np.float32)
    v = torch.as_tensor(rng.standard_normal((b, h, s, d)).astype(np.float32)).bfloat16()
    seg = _case(case, rng, b, s)
    dense = case == "dense"
    jseg = None if dense else jnp.asarray(seg)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v.float().numpy(), dtype=jnp.bfloat16), jseg,
                                   jseg, dense=dense, block_q=128, block_k=KERNEL_BLOCK_K,
                                   interpret=True, qkv_int8=True)).astype(np.float32)
    tseg = None if dense else torch.as_tensor(seg)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k), v, tseg, tseg, dense=dense,
                          qkv_int8=True, block_k=KERNEL_BLOCK_K).float().numpy()
    rows = np.ones((b, s), bool) if dense else seg >= 0
    mask = np.broadcast_to(rows[:, None], (b, h, s))
    np.testing.assert_allclose(got[mask], want[mask], atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,hq,hkv,s,dqk,dv", [(2, 4, 2, 130, 80, 80), (1, 2, 1, 64, 8, 4),
                                               (1, 2, 2, 200, 128, 128)])
def test_int8_prep_plain_matches_quant_rows_and_tiles(b, hq, hkv, s, dqk, dv):
    """The prep kernel's plain version: q and k rows equal to quantize_kv and
    JAX's _quant_rows_i8 on the same bf16 inputs, zero-padded to the plan's
    Dqk_pad; v's tiles of KERNEL_BLOCK_K keys quantized per column as the
    Pallas kernel does inside its body (:147-150, the tail tile padded with
    zeros), stored as V8^T with each 32-key group in k7_key_order, scales
    beside them; pad columns are zero with the 1e-8 floor's scale."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_int8_prep_reference,
        k7_key_order,
        plan_flash_int8,
    )
    from glimpseprune_torch.ops.kv_cache import quantize_kv

    rng = np.random.default_rng(b * 100 + s)
    q, k, v = (torch.as_tensor(rng.standard_normal(sh).astype(np.float32)).bfloat16()
               for sh in ((b, hq, s, dqk), (b, hkv, s, dqk), (b, hkv, s, dv)))
    v[:, :, 3] = 0.0  # a zero key
    plan = plan_flash_int8(dqk, dv, s, True)
    q8, qsc, k8, ksc, v8t, vsc = flash_int8_prep_reference(q, k, v, True)
    for x, x8, xsc in ((q, q8, qsc), (k, k8, ksc)):
        assert x8.dtype == torch.int8 and x8.shape == x.shape[:3] + (plan.dqk_pad,)
        assert not x8[..., x.shape[-1]:].any()
        want8, want_sc = quantize_kv(x)
        assert torch.equal(x8[..., :x.shape[-1]], want8) and torch.equal(xsc, want_sc)
        j8, jsc = _quant_rows_i8(jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16))
        np.testing.assert_array_equal(x8[..., :x.shape[-1]].numpy(), np.asarray(j8))
        np.testing.assert_array_equal(xsc.numpy(), np.asarray(jsc))
    n_kt, bk = plan.kv_tiles, KERNEL_BLOCK_K
    assert v8t.shape == (b, hkv, n_kt, plan.dv_pad, bk) and v8t.dtype == torch.int8
    assert vsc.shape == (b, hkv, n_kt, plan.dv_pad)
    vt = np.zeros((b, hkv, n_kt * bk, dv), np.float32)
    vt[:, :, :s] = v.float().numpy()
    vt = jnp.asarray(vt.reshape(b, hkv, n_kt, bk, dv))
    jsc = jnp.maximum(jnp.max(jnp.abs(vt), axis=-2, keepdims=True), 1e-8) / 127.0
    j8 = jnp.clip(jnp.round(vt / jsc), -127, 127).astype(jnp.int8)
    order = (torch.arange(0, bk, 32)[:, None] + k7_key_order()).flatten()
    natural = torch.empty_like(v8t)
    natural[..., order] = v8t  # V8^T back to the natural key order
    np.testing.assert_array_equal(natural[..., :dv, :].transpose(-1, -2).numpy(), np.asarray(j8))
    np.testing.assert_array_equal(vsc[..., :dv].numpy(), np.asarray(jsc)[..., 0, :])
    assert not v8t[..., dv:, :].any()
    assert torch.equal(vsc[..., dv:], torch.full_like(vsc[..., dv:], 1e-8) / 127.0)
    # without pv_int8 the prep leaves v alone
    assert flash_int8_prep_reference(q, k, v, False)[4:] == (None, None)

"""The plain versions of K2-lse and K3 (the training flavour of flash
attention and its backward, glimpseprune_torch/ops/cuda/flash_attention.py)
against the Pallas kernels they replace, run in interpret mode on the CPU:
the forward's log2-domain LSE against ``_flash_attention_impl(...,
return_lse=True)``, the plain backward against ``_flash_bwd_impl``, and the
gradients of ``flash_attention`` under autograd against ``jax.grad`` through
the Pallas ``flash_attention``. Same four cases as the forward's test
(causal GQA with left pads, segmented, dense, Dqk != Dv), fp32 numpy
inputs. Only valid rows are compared: a padding row's output, LSE and
gradient are 0, -1e30 and 0 by construction on both sides, but the Pallas
kernels compute them on padded blocks. The CUDA kernels are held to these
plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.ops.pallas.flash_attention import (
    _flash_attention_impl,
    _flash_bwd_impl,
)
from glimpseprune_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
from test_torch_kernels_ref import _segments

# fp32 on both sides; the sums are taken in another order and the
# gradients are products of several such sums, so 1e-4 (the outputs and
# gradients here are O(1))
TOL = dict(atol=1e-4, rtol=1e-4)
CASES = [
    ("causal", 4, 2, 32, 32),
    ("segmented", 2, 2, 16, 16),
    ("dense", 2, 2, 16, 16),
    ("dqk_ne_dv", 2, 2, 24, 8),
]
B, S = 2, 128


def _inputs(case, hq, hkv, dqk, dv):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, hq, S, dqk)).astype(np.float32)
    k = rng.standard_normal((B, hkv, S, dqk)).astype(np.float32)
    v = rng.standard_normal((B, hkv, S, dv)).astype(np.float32)
    dout = rng.standard_normal((B, hq, S, dv)).astype(np.float32)
    seg = _segments(case, B, S, rng)
    rows = np.ones((B, S), bool) if seg is None else seg >= 0
    return q, k, v, dout, seg, rows


def _pad_v(x, dqk):
    """The Pallas kernels take one head dim: zero columns added to v (and
    to dO and O) contribute nothing, as the JAX fuser's call pads them."""
    return np.pad(x, ((0, 0), (0, 0), (0, 0), (0, dqk - x.shape[-1])))


def _jseg(seg):
    return jnp.zeros((B, S), jnp.int32) if seg is None else jnp.asarray(seg)


def _rows(mask, h):
    return np.broadcast_to(mask[:, None], (B, h, S))


@pytest.mark.parametrize("case,hq,hkv,dqk,dv", CASES)
def test_lse_plain_matches_pallas(case, hq, hkv, dqk, dv):
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import flash_attention_lse

    q, k, v, _, seg, rows = _inputs(case, hq, hkv, dqk, dv)
    causal, dense = case == "causal", case == "dense"
    out_j, lse_j = _flash_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(_pad_v(v, dqk)), _jseg(seg), _jseg(seg),
        causal=causal, dense=dense, block_q=64, block_k=64, interpret=True, return_lse=True)
    tseg = None if dense else torch.as_tensor(seg)
    out_t, lse_t = flash_attention_lse(torch.as_tensor(q), torch.as_tensor(k),
                                       torch.as_tensor(v), tseg, tseg, causal=causal,
                                       dense=dense)
    assert lse_t.shape == (B, hq, S) and lse_t.dtype == torch.float32
    mask = _rows(rows, hq)
    np.testing.assert_allclose(lse_t.numpy()[mask], np.asarray(lse_j)[mask], **TOL)
    np.testing.assert_allclose(out_t.numpy()[mask], np.asarray(out_j)[..., :dv][mask], **TOL)
    if not dense:  # a row with no allowed key carries the -1e30 floor
        assert (lse_t.numpy()[~mask] == -1e30).all()


@pytest.mark.parametrize("case,hq,hkv,dqk,dv", CASES)
def test_backward_plain_matches_pallas(case, hq, hkv, dqk, dv):
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention_backward,
        flash_attention_lse,
    )

    q, k, v, dout, seg, rows = _inputs(case, hq, hkv, dqk, dv)
    causal, dense = case == "causal", case == "dense"
    tseg = None if dense else torch.as_tensor(seg)
    tq, tk, tv = torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v)
    out, lse = flash_attention_lse(tq, tk, tv, tseg, tseg, causal=causal, dense=dense)
    dq_t, dk_t, dv_t = flash_attention_backward(tq, tk, tv, tseg, tseg, out, lse,
                                                torch.as_tensor(dout), causal=causal,
                                                dense=dense)
    dq_j, dk_j, dv_j = _flash_bwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(_pad_v(v, dqk)), _jseg(seg), _jseg(seg),
        jnp.asarray(_pad_v(out.numpy(), dqk)), jnp.asarray(lse.numpy()),
        jnp.asarray(_pad_v(dout, dqk)), causal=causal, sm_scale=1.0 / dqk ** 0.5,
        block_q=64, block_k=64, interpret=True)
    assert dq_t.shape == q.shape and dk_t.shape == k.shape and dv_t.shape == v.shape
    qmask, kmask = _rows(rows, hq), _rows(rows, hkv)
    np.testing.assert_allclose(dq_t.numpy()[qmask], np.asarray(dq_j)[qmask], **TOL)
    np.testing.assert_allclose(dk_t.numpy()[kmask], np.asarray(dk_j)[kmask], **TOL)
    np.testing.assert_allclose(dv_t.numpy()[kmask], np.asarray(dv_j)[..., :dv][kmask], **TOL)


@pytest.mark.parametrize("case,hq,hkv,dqk,dv", CASES)
def test_autograd_matches_jax_grad(case, hq, hkv, dqk, dv):
    """d/d(q, k, v) of sum(flash_attention(q, k, v) * dO) over valid rows:
    the port's FlashAttentionFunction against jax.grad through the Pallas
    kernel's custom VJP (the fuser's pad-and-slice call for Dqk != Dv)."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention,
        flash_attention_backward,
    )

    q, k, v, dout, seg, rows = _inputs(case, hq, hkv, dqk, dv)
    causal, dense = case == "causal", case == "dense"
    dout_valid = dout * _rows(rows, hq)[..., None]

    def loss_j(q_, k_, v_):
        vp = jnp.pad(v_, ((0, 0), (0, 0), (0, 0), (0, dqk - dv)))
        out = pallas_flash(q_, k_, vp, None if dense else _jseg(seg),
                           None if dense else _jseg(seg), causal=causal, dense=dense,
                           block_q=64, block_k=64, interpret=True)[..., :dv]
        return jnp.sum(out * dout_valid)

    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v))
    tseg = None if dense else torch.as_tensor(seg)
    tq, tk, tv = (torch.as_tensor(x).requires_grad_(True) for x in (q, k, v))
    launches = dict(flash_attention_backward.launches)
    out = flash_attention(tq, tk, tv, tseg, tseg, causal=causal, dense=dense)
    (out * torch.as_tensor(dout_valid)).sum().backward()
    assert flash_attention_backward.launches == launches  # CPU: the plain versions
    qmask, kmask = _rows(rows, hq), _rows(rows, hkv)
    for got, want, mask in zip((tq.grad, tk.grad, tv.grad), grads_j, (qmask, kmask, kmask)):
        np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask], **TOL)


def test_no_grad_takes_the_plain_forward():
    """Without autograd recording, flash_attention is the K2 forward (no
    LSE); with it, the call goes through FlashAttentionFunction."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        FlashAttentionFunction,
        flash_attention,
    )

    rng = np.random.default_rng(2)
    q = torch.as_tensor(rng.standard_normal((1, 2, 16, 8)).astype(np.float32))
    with torch.no_grad():
        assert flash_attention(q, q, q, None, None, dense=True).grad_fn is None
    out = flash_attention(q.requires_grad_(True), q, q, None, None, dense=True)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == FlashAttentionFunction.__name__ + "Backward"

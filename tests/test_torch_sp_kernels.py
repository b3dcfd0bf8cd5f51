"""The plain versions of K9, the q_positions flavours of the flash kernel
(glimpseprune_torch/ops/cuda/flash_attention.py: forward, forward with
LSE, backward, int8), against the Pallas kernels they replace in
interpret mode, on the shapes of tests/test_sp.py: B=2, H=2, S=512, D=32,
row 1 left-padded by 17, q cut into 4 shards and one shard [100:160] that
no block boundary aligns, k and v whole. Then the shards of the plain
versions against one unsharded causal call. chip_smoke.py holds the CUDA
kernels to these plain versions on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.ops.pallas.flash_attention import _flash_attention_impl
from glimpseprune_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash

B, H, S, D = 2, 2, 512, 32
SHARDS = {f"quarter{i}": (i * S // 4, (i + 1) * S // 4) for i in range(4)}
SHARDS["unaligned"] = (100, 160)
BLOCK = dict(block_q=128, block_k=128)
# fp32 on both sides, sums in another order (the gradients are products of
# several such sums): 1e-5 for outputs and LSE, 1e-4 for gradients
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
# int8: exact int32 scores, so TOL. Under pv_int8 an exp2 ulp apart can
# flip one rounding of p * 127, which moves an output by up to
# v_scale * 127 / 127 / l <= max|v| / 127 (l >= 1): that bounds every entry,
# and flips are rare, so the RMS difference stays at the fp32 level
PV_RMS = 2e-5
# shards against one unsharded call of the same plain version: the same
# fp32 arithmetic on fewer rows
SHARD_TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, dout = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4))
    seg = np.zeros((B, S), np.int32)
    seg[1, :17] = -1  # left padding
    return q, k, v, dout, seg


def _shard(name):
    lo, hi = SHARDS[name]
    qpos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32), (B, hi - lo)).copy()
    return lo, hi, qpos


def _torch(*arrays):
    import torch

    return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("shard", list(SHARDS))
def test_k9_forward_and_lse_plain_match_pallas(shard):
    from glimpseprune_torch.ops.cuda.flash_attention import flash_attention, flash_attention_lse

    q, k, v, _, seg = _inputs()
    lo, hi, qpos = _shard(shard)
    jargs = (jnp.asarray(q[:, :, lo:hi]), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(seg[:, lo:hi]), jnp.asarray(seg))
    want = np.asarray(pallas_flash(*jargs, causal=True, interpret=True,
                                   q_positions=jnp.asarray(qpos), **BLOCK))
    want_o, want_lse = _flash_attention_impl(*jargs, causal=True, interpret=True,
                                             q_positions=jnp.asarray(qpos), return_lse=True,
                                             **BLOCK)
    tq, tk, tv, tqseg, tseg, tpos = _torch(q[:, :, lo:hi], k, v, seg[:, lo:hi], seg, qpos)
    got = flash_attention(tq, tk, tv, tqseg, tseg, causal=True, q_positions=tpos)
    got_o, got_lse = flash_attention_lse(tq, tk, tv, tqseg, tseg, causal=True, q_positions=tpos)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    rows = np.broadcast_to((seg[:, lo:hi] >= 0)[:, None], (B, H, hi - lo))
    np.testing.assert_allclose(got_lse.numpy()[rows], np.asarray(want_lse)[rows], **TOL)
    assert (got_lse.numpy()[~rows] == -1e30).all()


@pytest.mark.parametrize("shard", list(SHARDS))
def test_k9_backward_plain_matches_pallas(shard):
    """dq, dk, dv of the shard's attention under autograd (the plain K9-lse
    and K9 backward) against jax.grad through the Pallas q_positions VJP."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import flash_attention

    q, k, v, dout, seg = _inputs()
    lo, hi, qpos = _shard(shard)
    g = dout[:, :, lo:hi]

    def loss(q_, k_, v_):
        out = pallas_flash(q_, k_, v_, jnp.asarray(seg[:, lo:hi]), jnp.asarray(seg),
                           causal=True, interpret=True, q_positions=jnp.asarray(qpos), **BLOCK)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q[:, :, lo:hi]), jnp.asarray(k),
                                             jnp.asarray(v))
    tq, tk, tv = (t.requires_grad_(True) for t in _torch(q[:, :, lo:hi], k, v))
    tqseg, tseg, tpos, tg = _torch(seg[:, lo:hi], seg, qpos, g)
    out = flash_attention(tq, tk, tv, tqseg, tseg, causal=True, q_positions=tpos)
    got = torch.autograd.grad(out, (tq, tk, tv), tg)
    rows = np.broadcast_to((seg[:, lo:hi] >= 0)[:, None, :, None], (B, H, hi - lo, D))
    np.testing.assert_allclose(got[0].numpy()[rows], np.asarray(want[0])[rows], **GRAD_TOL)
    for name, gt, wt in zip(("dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("pv", [False, True])
@pytest.mark.parametrize("shard", list(SHARDS))
def test_k9_int8_plain_matches_pallas(shard, pv):
    from glimpseprune_torch.ops.cuda.flash_attention import flash_attention

    q, k, v, _, seg = _inputs()
    lo, hi, qpos = _shard(shard)
    want = np.asarray(pallas_flash(
        jnp.asarray(q[:, :, lo:hi]), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg[:, lo:hi]),
        jnp.asarray(seg), causal=True, interpret=True, qkv_int8=True, pv_int8=pv,
        q_positions=jnp.asarray(qpos), **BLOCK))
    tq, tk, tv, tqseg, tseg, tpos = _torch(q[:, :, lo:hi], k, v, seg[:, lo:hi], seg, qpos)
    got = flash_attention(tq, tk, tv, tqseg, tseg, causal=True, qkv_int8=True, pv_int8=pv,
                          block_k=BLOCK["block_k"], q_positions=tpos).numpy()
    rows = np.broadcast_to((seg[:, lo:hi] >= 0)[:, None], (B, H, hi - lo))
    if not pv:
        np.testing.assert_allclose(got[rows], want[rows], **TOL)
        return
    np.testing.assert_allclose(got[rows], want[rows], atol=np.abs(v).max() / 127, rtol=0)
    assert np.sqrt(np.mean((got[rows] - want[rows]) ** 2)) < PV_RMS


@pytest.mark.parametrize("flavour", ["forward", "lse", "int8", "int8+pv8", "backward"])
def test_k9_shards_equal_unsharded_causal(flavour):
    """The 4 shards concatenated (dk, dv summed over the shards, as SP's
    gather_kv backward sums them) and the unaligned shard against one
    unsharded causal call of the same plain version."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention,
        flash_attention_backward,
        flash_attention_lse,
    )

    q, k, v, dout, seg = _inputs()
    tk, tv, tseg = _torch(k, v, seg)
    int8 = dict(qkv_int8=True, block_k=128, pv_int8=flavour == "int8+pv8")

    def run(lo, hi, qpos=None):
        tq, tqseg, tg = _torch(q[:, :, lo:hi], seg[:, lo:hi], dout[:, :, lo:hi])
        tpos = None if qpos is None else _torch(qpos)[0]
        if flavour.startswith("int8"):
            return (flash_attention(tq, tk, tv, tqseg, tseg, causal=True, q_positions=tpos,
                                    **int8),)
        out, lse = flash_attention_lse(tq, tk, tv, tqseg, tseg, causal=True, q_positions=tpos)
        if flavour == "forward":
            return (out,)
        if flavour == "lse":
            return (lse,)
        return flash_attention_backward(tq, tk, tv, tqseg, tseg, out, lse, tg, causal=True,
                                        q_positions=tpos)

    whole = run(0, S)
    parts = [run(*SHARDS[f"quarter{i}"][:2], _shard(f"quarter{i}")[2]) for i in range(4)]
    np.testing.assert_allclose(torch.cat([p[0] for p in parts], 2).numpy(), whole[0].numpy(),
                               **SHARD_TOL)
    if flavour == "backward":  # dk, dv: the shards' parts summed
        for i in (1, 2):
            np.testing.assert_allclose(sum(p[i] for p in parts).numpy(), whole[i].numpy(),
                                       **SHARD_TOL)
    lo, hi, qpos = _shard("unaligned")
    part = run(lo, hi, qpos)
    np.testing.assert_allclose(part[0].numpy(), whole[0][:, :, lo:hi].numpy(), **SHARD_TOL)

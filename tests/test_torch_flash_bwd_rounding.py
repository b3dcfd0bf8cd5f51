"""The rounding of the tensor-core backward (csrc/flash_attention_bwd.cu),
emulated on the CPU before the card checks it: inputs in bf16, k tiles of
64 keys, each q tile of 64 rows walking the k tiles that the kernel lists
(up to the causal limit, less those whose segment range misses the q
tile's) in ascending order, P and dS rounded to bf16 before their
products, fp32 sums, bf16 outputs. The emulation lives here, not in the
package: the package's plain version stays the fp32 function.

1. On the four cases of test_torch_flash_grad.py it stays within the limits
   chip_smoke.py holds the kernel to (per gradient, max err / max |ref| <=
   2^-7 and RMS err / RMS ref <= 2^-8) of the Pallas ``_flash_bwd_impl`` in
   interpret mode, and the control with dS in 4 significant bits does not.
2. Under that tiling a q shard's dq (q_positions, K9) equals the whole
   sequence's rows bit for bit: the tile products here are sums taken key
   by key and feature by feature, so a row's value depends on its own
   inputs and on the tiles it visits alone."""

import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.ops.pallas.flash_attention import _flash_bwd_impl
from test_torch_kernels_ref import _segments

CASES = [
    ("causal", 4, 2, 32, 32),
    ("segmented", 2, 2, 16, 16),
    ("dense", 2, 2, 16, 16),
    ("dqk_ne_dv", 2, 2, 24, 8),
]
B, S = 2, 128
TILE = 64
MAX_RTOL, RMS_RTOL = 2 ** -7, 2 ** -8


def _bf16(x):
    import torch

    return x.to(torch.bfloat16).float()


def _round4(x):
    """x with 4 significant bits (the control)."""
    import torch

    mant, exp = torch.frexp(x)
    return torch.ldexp(torch.round(mant * 16) / 16, exp)


def _dot(a, b):
    """[..., n, D] x [..., m, D] -> [..., n, m] in fp32, summed feature by
    feature: each entry depends on its own row and column alone."""
    acc = a[..., :, None, 0] * b[..., None, :, 0]
    for d in range(1, a.shape[-1]):
        acc = acc + a[..., :, None, d] * b[..., None, :, d]
    return acc


def _tile_range(seg, lo, hi):
    """(smallest, largest segment id >= 0) of rows [lo, hi) of each batch
    row, as the kernel's tile_range: (INT_MAX, -1) without one."""
    import torch

    s = seg[:, lo:hi]
    valid = s >= 0
    return torch.where(valid, s, torch.iinfo(torch.int32).max).amin(1), torch.where(
        valid, s, -1).amax(1)


def emulate_backward(q, k, v, dout, out, lse, qseg, kseg, causal, dense, qpos=None,
                     round_ds=_bf16):
    """dq, dk, dv (fp32 holding bf16 values) as the tensor-core kernels
    round them; q, k, v, dout hold bf16 values, out and lse come from the
    forward, segment ids [B, S] (ignored when dense), qpos [B, Sq]."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import LOG2E, NEG_INF, allowed_mask

    b, hq, sq, dqk = q.shape
    hkv, skv, dv = v.shape[1], v.shape[2], v.shape[3]
    g = hq // hkv
    kf, vf = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    scale = 1.0 / dqk ** 0.5
    allowed = allowed_mask(qseg, kseg, b, sq, skv, causal, dense, "cpu", qpos)[:, None]
    allowed = allowed & (lse > NEG_INF / 2)[..., None]
    dsum = (dout * out).sum(-1)
    if dense:
        qseg = torch.zeros((b, sq), dtype=torch.int32)
        kseg = torch.zeros((b, skv), dtype=torch.int32)
    pos = (torch.arange(sq, dtype=torch.int32).expand(b, sq) if qpos is None else qpos)
    dq = torch.zeros((b, hq, sq, dqk))
    dk = torch.zeros((b, hq, skv, dqk))
    dvv = torch.zeros((b, hq, skv, dv))
    for bi in range(b):
        for q0 in range(0, sq, TILE):
            rows = slice(q0, min(q0 + TILE, sq))
            qlo, qhi = (x[bi].item() for x in _tile_range(qseg, q0, q0 + TILE))
            pmax = pos[bi, rows].max().item()
            n_kt = 0 if qhi < 0 else -(-skv // TILE)
            if causal:
                n_kt = min(n_kt, 0 if pmax < 0 else pmax // TILE + 1)
            for t0 in range(0, n_kt * TILE, TILE):
                klo, khi = (x[bi].item() for x in _tile_range(kseg, t0, t0 + TILE))
                if not (khi >= qlo and klo <= qhi):
                    continue
                keys = slice(t0, min(t0 + TILE, skv))
                qt, dot_ = q[bi, :, rows], dout[bi, :, rows]
                kt, vt = kf[bi, :, keys], vf[bi, :, keys]
                ok = allowed[bi, :, rows, keys]
                lse_t = lse[bi, :, rows, None]
                p = torch.where(ok, torch.exp2(_dot(qt, kt) * (scale * LOG2E) - lse_t), 0.0)
                ds = p * (_dot(dot_, vt) - dsum[bi, :, rows, None])
                p16, ds16 = _bf16(p), round_ds(ds)
                acc = dq[bi, :, rows]
                for j in range(kt.shape[1]):  # key by key: a row's sum is its own
                    acc = acc + ds16[..., j, None] * kt[:, j, None, :]
                dq[bi, :, rows] = acc
                dk[bi, :, keys] += ds16.transpose(-1, -2) @ qt
                dvv[bi, :, keys] += p16.transpose(-1, -2) @ dot_
    dk = dk.reshape(b, hkv, g, skv, dqk).sum(2)
    dvv = dvv.reshape(b, hkv, g, skv, dv).sum(2)
    return _bf16(dq * scale), _bf16(dk * scale), _bf16(dvv)


def _inputs(case, hq, hkv, dqk, dv):
    rng = np.random.default_rng(11)

    def bf16(shape):  # bf16-valued fp32, as the kernel reads them
        import torch

        return _bf16(torch.as_tensor(rng.standard_normal(shape).astype(np.float32))).numpy()

    q, k = bf16((B, hq, S, dqk)), bf16((B, hkv, S, dqk))
    v, dout = bf16((B, hkv, S, dv)), bf16((B, hq, S, dv))
    return q, k, v, dout, _segments(case, B, S, rng)


def _errs(got, ref):
    d = got - ref
    return (np.abs(d).max() / np.abs(ref).max(),
            np.sqrt((d ** 2).sum()) / np.sqrt((ref ** 2).sum()))


def _forward(q, k, v, seg, causal, dense, qpos=None):
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import flash_attention_lse

    tseg = None if dense else torch.as_tensor(seg)
    out, lse = flash_attention_lse(*(torch.as_tensor(x) for x in (q, k, v)), tseg, tseg,
                                   causal=causal, dense=dense, q_positions=qpos)
    return _bf16(out), lse  # the kernel's forward writes bf16


@pytest.mark.parametrize("case,hq,hkv,dqk,dv", CASES)
def test_emulated_rounding_within_card_limits(case, hq, hkv, dqk, dv):
    import torch

    q, k, v, dout, seg = _inputs(case, hq, hkv, dqk, dv)
    causal, dense = case == "causal", case == "dense"
    out, lse = _forward(q, k, v, seg, causal, dense)
    jseg = jnp.zeros((B, S), jnp.int32) if dense else jnp.asarray(seg)

    def pad(x):  # Pallas takes one head dim: zero columns of v, dO, O add nothing
        return np.pad(x, ((0, 0), (0, 0), (0, 0), (0, dqk - x.shape[-1])))

    want = _flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pad(v)), jseg, jseg,
                           jnp.asarray(pad(out.numpy())), jnp.asarray(lse.numpy()),
                           jnp.asarray(pad(dout)), causal=causal, sm_scale=1.0 / dqk ** 0.5,
                           block_q=64, block_k=64, interpret=True)
    want = [np.asarray(want[0]), np.asarray(want[1]), np.asarray(want[2])[..., :dv]]
    tseg = None if dense else torch.as_tensor(seg)
    args = [torch.as_tensor(x) for x in (q, k, v, dout)] + [out, lse, tseg, tseg, causal, dense]
    got = emulate_backward(*args)
    control = emulate_backward(*args, round_ds=_round4)
    rows = np.ones((B, S), bool) if dense else seg >= 0
    masks = [np.broadcast_to(rows[:, None], (B, hq, S)), np.broadcast_to(rows[:, None],
                                                                         (B, hkv, S))]
    for name, g_, c_, w_, m in zip(("dq", "dk", "dv"), got, control, want,
                                   (masks[0], masks[1], masks[1])):
        errs = _errs(g_.numpy()[m], w_[m])
        assert errs[0] <= MAX_RTOL and errs[1] <= RMS_RTOL, (name, errs)
        if name != "dv":  # the control rounds dS, which dv does not read
            c_errs = _errs(c_.numpy()[m], w_[m])
            assert c_errs[0] > MAX_RTOL and c_errs[1] > RMS_RTOL, (name, c_errs)


@pytest.mark.parametrize("lo,hi", [(0, 64), (64, 128), (0, 32), (32, 64), (40, 100)])
def test_emulated_shard_dq_equals_whole_rows(lo, hi):
    import torch

    q, k, v, dout, seg = _inputs("causal", 4, 2, 32, 32)
    out, lse = _forward(q, k, v, seg, True, False)
    tq, tk, tv, tdo, tseg = (torch.as_tensor(x) for x in (q, k, v, dout, seg))
    whole = emulate_backward(tq, tk, tv, tdo, out, lse, tseg, tseg, True, False)
    qpos = torch.arange(lo, hi, dtype=torch.int32).expand(B, hi - lo).contiguous()
    rows = [x[:, :, lo:hi].contiguous() for x in (tq, tdo, out, lse)]
    shard = emulate_backward(rows[0], tk, tv, rows[1], rows[2], rows[3],
                             tseg[:, lo:hi].contiguous(), tseg, True, False, qpos)
    assert torch.equal(shard[0], whole[0][:, :, lo:hi])

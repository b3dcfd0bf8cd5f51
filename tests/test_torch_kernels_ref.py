"""The plain PyTorch versions of the two CUDA kernels against the Pallas
kernels they replace, run in Pallas interpret mode on the CPU: K1 (fused
rope + window attention) and K2 (flash attention: causal GQA with left
pads, segmented bidirectional, dense, Dqk != Dv). fp32 throughout; the
tolerance covers summation order only. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
from glimpseprune_tpu.ops.pallas.window_attention import window_attention_fused as pallas_window
from glimpseprune_tpu.ops.rope import vision_rope_cos_sin as jax_vision_rope

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("nw,wp,h,d", [(5, 16, 4, 16), (3, 64, 2, 80)])
def test_window_attention_plain_matches_pallas(nw, wp, h, d):
    import torch

    from glimpseprune_torch.ops.cuda.window_attention import window_attention_fused

    rng = np.random.default_rng(nw)
    p = nw * wp
    qkv = rng.standard_normal((p, 3, h, d)).astype(np.float32)
    pos = rng.integers(0, 20, (p, 2)).astype(np.int32)
    valid = rng.random(p) > 0.25
    valid[-wp:] = False  # a whole padding window
    cos, sin = jax_vision_rope(jnp.asarray(pos), d)
    want = np.asarray(pallas_window(jnp.asarray(qkv), cos, sin, jnp.asarray(valid), wp,
                                    interpret=True))
    got = window_attention_fused(torch.as_tensor(qkv), torch.as_tensor(np.array(cos)),
                                 torch.as_tensor(np.array(sin)), torch.as_tensor(valid), wp)
    assert got.shape == (p, h, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _segments(case, b, s, rng):
    if case == "causal":  # left-padded rows, one segment
        seg = np.zeros((b, s), np.int32)
        for i, n_pad in enumerate(rng.integers(1, s // 2, b)):
            seg[i, :n_pad] = -1
        return seg
    if case == "dense":
        return None
    seg = np.zeros((b, s), np.int32)  # two images and a padding tail
    seg[:, 50:] = 1
    seg[:, -20:] = -1
    return seg


@pytest.mark.parametrize("case,hq,hkv,dqk,dv", [
    ("causal", 4, 2, 32, 32),
    ("segmented", 2, 2, 16, 16),
    ("dense", 2, 2, 16, 16),
    ("dqk_ne_dv", 2, 2, 24, 8),
])
def test_flash_attention_plain_matches_pallas(case, hq, hkv, dqk, dv):
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import flash_attention, flavour

    rng = np.random.default_rng(7)
    b, s = 2, 128
    q = rng.standard_normal((b, hq, s, dqk)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dqk)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dv)).astype(np.float32)
    seg = _segments(case, b, s, rng)
    causal, dense = case == "causal", case == "dense"
    assert flavour(causal, dense, dqk, dv) == case
    # the Pallas kernel needs Dv == Dqk: zero columns added to v contribute nothing
    v_pad = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, dqk - dv)))
    jseg = None if dense else jnp.asarray(seg)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v_pad), jseg,
                                   jseg, causal=causal, dense=dense, block_q=64, block_k=64,
                                   interpret=True))[..., :dv]
    tseg = None if dense else torch.as_tensor(seg)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                          tseg, tseg, causal=causal, dense=dense).numpy()
    assert got.shape == (b, hq, s, dv)
    rows = np.ones((b, s), bool) if dense else seg >= 0
    mask = np.broadcast_to(rows[:, None], (b, hq, s))
    np.testing.assert_allclose(got[mask], want[mask], **TOL)
    if not dense:  # a row with no allowed key is zero, as in the kernel
        assert np.abs(got.transpose(0, 2, 1, 3)[~rows]).max() == 0.0


def test_wrappers_dispatch_by_device():
    """A CPU tensor takes the plain version and launches nothing; a tensor
    on any other non-CUDA device is refused (there is no silent fallback)."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import flash_attention
    from glimpseprune_torch.ops.cuda.window_attention import window_attention_fused

    rng = np.random.default_rng(9)
    qkv = torch.as_tensor(rng.standard_normal((32, 3, 2, 8)).astype(np.float32))
    cos, sin = torch.ones(32, 8), torch.zeros(32, 8)
    valid = torch.ones(32, dtype=torch.bool)
    q = torch.as_tensor(rng.standard_normal((1, 2, 16, 8)).astype(np.float32))
    n_window = window_attention_fused.launches
    n_flash = dict(flash_attention.launches)
    window_attention_fused(qkv, cos, sin, valid, 16)
    flash_attention(q, q, q, None, None, dense=True)
    assert window_attention_fused.launches == n_window
    assert flash_attention.launches == n_flash
    with pytest.raises(ValueError):
        window_attention_fused(qkv.to("meta"), cos, sin, valid, 16)
    with pytest.raises(ValueError):
        flash_attention(q.to("meta"), q, q, None, None, dense=True)
    with pytest.raises(ValueError):  # segment ids are required unless dense
        flash_attention(q, q, q, None, None)

"""The int8 tier of the port's decode KV cache (glimpseprune_torch/ops/
kv_cache.py) and decode attention over it, against the JAX package's on the
same numpy-seeded inputs: identical int8 values and scales from the same
prefix and appends, and the same attention output."""

import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.ops import attention as jax_attention
from glimpseprune_tpu.ops import kv_cache as jax_kv


def test_quantize_kv_matches_jax():
    import torch

    from glimpseprune_torch.ops import kv_cache

    kv = np.random.default_rng(0).standard_normal((3, 2, 7, 2, 16)).astype(np.float32)
    kv[0, 0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    q_j, s_j = jax_kv.quantize_kv(jnp.asarray(kv))
    q_t, s_t = kv_cache.quantize_kv(torch.as_tensor(kv))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32


def test_int8_cache_writes_match_jax():
    """Prefix and append land in place, byte for byte as JAX writes them."""
    import torch

    from glimpseprune_torch.ops import kv_cache

    rng = np.random.default_rng(1)
    shape = (3, 2, 10, 2, 8)
    prefix = rng.standard_normal((3, 2, 6, 2, 8)).astype(np.float32)
    new = rng.standard_normal((2, 1, 2, 8)).astype(np.float32)
    want = jax_kv.cache_set_prefix(jax_kv.alloc_cache(shape, jnp.float32, "int8"),
                                   jnp.asarray(prefix))
    want = jax_kv.cache_append(want, jnp.asarray(new), 2, 6)
    got = kv_cache.alloc_cache(shape, torch.float32, "cpu", "int8")
    q_buf = got["q"]
    kv_cache.cache_set_prefix(got, torch.as_tensor(prefix))
    kv_cache.cache_append(got, torch.as_tensor(new), 2, 6)
    assert got["q"] is q_buf  # written in place
    for key in ("q", "s"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    layer = kv_cache.cache_layer(got, 2)
    np.testing.assert_array_equal(layer["q"].numpy(), np.asarray(want["q"][2]))
    assert kv_cache.cache_nbytes(got) == jax_kv.cache_nbytes(want)
    with pytest.raises(ValueError):
        kv_cache.alloc_cache(shape, torch.float32, "cpu", "int4")


@pytest.mark.parametrize("s_new", [1, 3])
def test_decode_attention_int8_cache_matches_jax(s_new):
    """fp32 logits from the integer values times the key scale, the value
    scale folded into the probabilities: the same math as JAX (1e-5)."""
    import torch

    from glimpseprune_torch.ops import attention, kv_cache

    rng = np.random.default_rng(2)
    b, t, hq, hkv, d = 2, 12, 4, 2, 16
    q = rng.standard_normal((b, s_new, hq, d)).astype(np.float32)
    kc = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    kn = rng.standard_normal((b, s_new, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, s_new, hkv, d)).astype(np.float32)
    kv_valid = np.ones((b, t), bool)
    kv_valid[1, :4] = False  # left padding
    write_idx = 9
    kq_j, ks_j = jax_kv.quantize_kv(jnp.asarray(kc))
    vq_j, vs_j = jax_kv.quantize_kv(jnp.asarray(vc))
    want = jax_attention.decode_attention(
        jnp.asarray(q), {"q": kq_j, "s": ks_j}, {"q": vq_j, "s": vs_j},
        jnp.asarray(kv_valid), k_new=jnp.asarray(kn), v_new=jnp.asarray(vn),
        write_idx=jnp.int32(write_idx))
    kq, ks = kv_cache.quantize_kv(torch.as_tensor(kc))
    vq, vs = kv_cache.quantize_kv(torch.as_tensor(vc))
    got = attention.decode_attention(
        torch.as_tensor(q), {"q": kq, "s": ks}, {"q": vq, "s": vs},
        torch.as_tensor(kv_valid), torch.as_tensor(kn), torch.as_tensor(vn), write_idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

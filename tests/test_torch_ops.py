"""The port's tensor ops against the JAX package's: rope tables and
rotation, the keep policy (exact masks), compaction (exact indices,
positions and gathered KV), the bf16-layout KV cache writes, and decode
attention over a cache with the new tokens' keys."""

import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.ops import attention as jax_attention
from glimpseprune_tpu.ops import compaction as jax_compaction
from glimpseprune_tpu.ops import keep_policy as jax_keep
from glimpseprune_tpu.ops import kv_cache as jax_kv
from glimpseprune_tpu.ops import rope as jax_rope

TOL = dict(atol=1e-5, rtol=1e-5)


def test_rope_matches_jax():
    import torch

    from glimpseprune_torch.ops import rope

    rng = np.random.default_rng(0)
    pos3 = rng.integers(0, 300, (3, 2, 11))
    cos_j, sin_j = jax_rope.mrope_cos_sin(jnp.asarray(pos3), 16, 1e6, (2, 3, 3))
    cos_t, sin_t = rope.mrope_cos_sin(torch.as_tensor(pos3), 16, 1e6, (2, 3, 3))
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), **TOL)
    pos2 = rng.integers(0, 64, (13, 2))
    vcos_j, vsin_j = jax_rope.vision_rope_cos_sin(jnp.asarray(pos2), 80)
    vcos_t, vsin_t = rope.vision_rope_cos_sin(torch.as_tensor(pos2), 80)
    np.testing.assert_allclose(vcos_t.numpy(), np.asarray(vcos_j), **TOL)
    np.testing.assert_allclose(vsin_t.numpy(), np.asarray(vsin_j), **TOL)
    x = rng.standard_normal((2, 11, 3, 16)).astype(np.float32)
    want = jax_rope.apply_rotary(jnp.asarray(x), cos_j, sin_j)
    got = rope.apply_rotary(torch.as_tensor(x), cos_t, sin_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(rope.rotate_half(torch.as_tensor(x)).numpy(),
                                  np.asarray(jax_rope.rotate_half(jnp.asarray(x))))


@pytest.mark.parametrize("ratio,min_num,anchors", [
    (0.3, 1, False), (None, 3, False), (0.05, 2, True), (0.9, None, False)])
def test_keep_policy_matches_jax(ratio, min_num, anchors):
    import torch

    from glimpseprune_torch.ops import keep_policy

    rng = np.random.default_rng(1)
    probs = rng.random((4, 40)).astype(np.float32)
    probs[0, :10] = 0.7  # ties, broken by position
    probs[2] *= 0.4      # a row under the threshold everywhere
    valid = np.ones((4, 40), bool)
    valid[1, 25:] = False
    valid[3, 31:] = False
    anchor = (rng.random((4, 40)) < 0.05) if anchors else None
    want = jax_keep.keep_scores_with_policy(
        jnp.asarray(probs), jnp.asarray(valid), 0.5, ratio, min_num,
        None if anchor is None else jnp.asarray(anchor))
    got = keep_policy.keep_scores_with_policy(
        torch.as_tensor(probs), torch.as_tensor(valid), 0.5, ratio, min_num,
        None if anchor is None else torch.as_tensor(anchor))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compaction_matches_jax():
    import torch

    from glimpseprune_torch.ops import compaction

    rng = np.random.default_rng(2)
    b, l, r = 3, 30, 20
    keep = rng.random((b, l)) < 0.5
    keep[2] = rng.random(l) < 0.9  # more survivors than the budget: latest win
    plan_j = jax_compaction.compaction_indices(jnp.asarray(keep), r)
    plan_t = compaction.compaction_indices(torch.as_tensor(keep), r)
    for name in ("src", "valid", "n_kept"):
        np.testing.assert_array_equal(getattr(plan_t, name).numpy(),
                                      np.asarray(getattr(plan_j, name)), err_msg=name)
    ids = rng.integers(0, 500, (b, l))
    x = rng.standard_normal((b, l, 6)).astype(np.float32)
    pos = rng.integers(0, 99, (3, b, l))
    kv = rng.standard_normal((4, b, l, 2, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        compaction.gather_tokens(torch.as_tensor(ids), plan_t, fill=7).numpy(),
        np.asarray(jax_compaction.gather_tokens(jnp.asarray(ids), plan_j, fill=7)))
    np.testing.assert_array_equal(
        compaction.gather_tokens(torch.as_tensor(x), plan_t).numpy(),
        np.asarray(jax_compaction.gather_tokens(jnp.asarray(x), plan_j)))
    np.testing.assert_array_equal(
        compaction.gather_positions(torch.as_tensor(pos), plan_t).numpy(),
        np.asarray(jax_compaction.gather_positions(jnp.asarray(pos), plan_j)))
    np.testing.assert_array_equal(
        compaction.gather_kv(torch.as_tensor(kv), plan_t).numpy(),
        np.asarray(jax_compaction.gather_kv(jnp.asarray(kv), plan_j)))


def test_kv_cache_writes_match_jax():
    import torch

    from glimpseprune_torch.ops import kv_cache

    rng = np.random.default_rng(3)
    shape = (3, 2, 10, 2, 4)
    prefix = rng.standard_normal((3, 2, 6, 2, 4)).astype(np.float32)
    new = rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
    want = jax_kv.cache_set_prefix(jax_kv.alloc_cache(shape, jnp.float32, ""),
                                   jnp.asarray(prefix))
    want = jax_kv.cache_append(want, jnp.asarray(new), 1, 6)
    got = kv_cache.alloc_cache(shape, torch.float32, "cpu")
    kv_cache.cache_set_prefix(got, torch.as_tensor(prefix))
    kv_cache.cache_append(got, torch.as_tensor(new), 1, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(kv_cache.cache_layer(got, 1).numpy(),
                                  np.asarray(jax_kv.cache_layer(want, 1)))


@pytest.mark.parametrize("s_new", [1, 3])
def test_decode_attention_matches_jax(s_new):
    import torch

    from glimpseprune_torch.ops import attention

    rng = np.random.default_rng(4)
    b, t, hq, hkv, d = 2, 12, 4, 2, 8
    q = rng.standard_normal((b, s_new, hq, d)).astype(np.float32)
    kc = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    kn = rng.standard_normal((b, s_new, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, s_new, hkv, d)).astype(np.float32)
    kv_valid = np.ones((b, t), bool)
    kv_valid[0, :3] = False  # left padding
    write_idx = 8
    want = jax_attention.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kv_valid),
        k_new=jnp.asarray(kn), v_new=jnp.asarray(vn), write_idx=jnp.int32(write_idx))
    got = attention.decode_attention(
        torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc),
        torch.as_tensor(kv_valid), torch.as_tensor(kn), torch.as_tensor(vn), write_idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

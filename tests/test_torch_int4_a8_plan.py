"""K6's two stages on the CPU (glimpseprune_torch/ops/cuda/int4_matmul.py):
the plain prep and GEMM composed against ``int4_prefill_a8_reference`` bit
for bit, the prep's outputs against the JAX package's arithmetic and
``quantize_kv``, and the host plan ``plan_int4_a8`` against the card's
limits and the constants of csrc/int4_matmul.cu, which the C launcher holds
a plan to. On the card chip_smoke.py holds the kernels to these plain
versions bit for bit."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glimpseprune_tpu import quantization as jq
from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.ops.cuda import build
from glimpseprune_torch.ops.cuda import int4_matmul as tm4
from glimpseprune_torch.ops.kv_cache import quantize_kv

CSRC = Path(tm4.__file__).resolve().parents[2] / "csrc"
CONFIG = Path(__file__).resolve().parents[1] / "configs" / "model_qwen2_5_7b_gp"


def _packed(seed, k, n):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    tree = jq.quantize_int4({"text": {"layers": {"l0": {"kernel": jnp.asarray(w)}}}})
    leaf = tree["text"]["layers"]["l0"]
    return np.array(leaf["kernel_q4"]), np.array(leaf["kernel_scale4"])


def _x(m, k, seed):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes the 1e-8 floor
    return torch.as_tensor(x).bfloat16()


@pytest.mark.parametrize("m,k,n", [(129, 256, 128), (256, 512, 256), (1662, 256, 128)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_a8_stages_compose_to_reference(m, k, n, out_dtype):
    """prep then GEMM equals the one-piece plain version, and the CPU path
    of matmul_int4_prefill, bit for bit (a ragged M included)."""
    packed, scales = (torch.as_tensor(a) for a in _packed(m, k, n))
    x = _x(m, k, m + k)
    xq, xs, w8t, s8 = tm4.int4_a8_prep_reference(x, packed, scales)
    got = tm4.int8_gemm_tn_reference(xq, xs, w8t, s8, out_dtype)
    xq_kv, xs_kv = quantize_kv(x)
    s8_r, r = tm4.requant_ratios(scales)
    want = tm4.int4_prefill_a8_reference(xq_kv, xs_kv[:, None], packed, r, s8_r, out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, want)
    assert torch.equal(tm4.matmul_int4_prefill(x, packed, scales, out_dtype, a8=True), want)


@pytest.mark.parametrize("k,n,seed", [(256, 128, 0), (1024, 512, 1)])
def test_a8_prep_matches_jax_arithmetic(k, n, seed):
    """s8 and r as matmul_int4_prefill computes them (JAX :341-342), q8 as
    _kernel_prefill_a8 requantizes the nibbles (:232-237), and xq, xs as
    its wrapper quantizes x (:336-339) and as quantize_kv does, on the same
    numpy inputs; the prep returns W8^T, [N, K]."""
    packed, scales = _packed(seed, k, n)
    x = _x(160, k, seed + 7)
    xq, xs, w8t, s8 = tm4.int4_a8_prep_reference(x, torch.as_tensor(packed),
                                                 torch.as_tensor(scales))
    sc = jnp.asarray(scales)
    s8_j = jnp.maximum(jnp.max(sc, axis=-2, keepdims=True), 1e-12) * (7.0 / 127.0)
    r_j = sc / s8_j
    g = k // scales.shape[0]
    p32 = jnp.asarray(packed).astype(jnp.int32)
    lo = jnp.right_shift(jnp.left_shift(p32, 28), 28).astype(jnp.float32)
    hi = jnp.right_shift(p32, 4).astype(jnp.float32)
    rows = jnp.repeat(r_j, g, axis=0)
    q8_j = jnp.concatenate([jnp.round(lo * rows[:k // 2]), jnp.round(hi * rows[k // 2:])]
                           ).astype(jnp.int8)
    assert w8t.shape == (n, k) and w8t.dtype == torch.int8 and w8t.is_contiguous()
    np.testing.assert_array_equal(w8t.t().numpy(), np.asarray(q8_j))
    np.testing.assert_array_equal(s8.numpy(), np.asarray(s8_j)[0])
    _, r = tm4.requant_ratios(torch.as_tensor(scales))
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_j))
    assert int(w8t.abs().max()) <= 127

    xf = jnp.asarray(x.float().numpy())
    xs_j = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8) / 127.0
    xq_j = jnp.clip(jnp.round(xf / xs_j), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xs_j)[:, 0])
    xq_kv, xs_kv = quantize_kv(x)
    assert torch.equal(xq, xq_kv) and torch.equal(xs, xs_kv)
    assert xs.shape == (160,) and xs.dtype == torch.float32 and s8.shape == (n,)


def _decoder_shapes():
    t = ModelConfig.load(str(CONFIG)).text
    kv = t.num_key_value_heads * t.head_dim
    return {"q_o": (t.hidden_size, t.hidden_size), "k_v": (t.hidden_size, kv),
            "gate_up": (t.hidden_size, t.intermediate_size),
            "down": (t.intermediate_size, t.hidden_size)}


@pytest.mark.parametrize("m", [1662, 1664])
@pytest.mark.parametrize("name", ["q_o", "k_v", "gate_up", "down"])
def test_plan_fills_the_card(name, m):
    """At the 7B decoder shapes and the smoke's prefill M (1664, and the
    unpruned prefill's ragged 1662), both kernels' grids fill the 132 SMs
    and a block's shared memory stays within 227 KB."""
    k, n = _decoder_shapes()[name]
    plan = tm4.plan_int4_a8(m, k, n)
    assert plan.blocks >= tm4.A8_SMS and plan.prep_blocks >= tm4.A8_SMS
    assert plan.smem_bytes <= build.SMEM_LIMIT == 227 * 1024
    assert plan.grid_m * plan.bm >= m > (plan.grid_m - 1) * plan.bm
    assert plan.grid_n * plan.bn == n
    bm, bn, wm, wn, _, stages = tm4.A8_TILES[plan.tile]
    assert (plan.bm, plan.bn, plan.warps, plan.stages) == (bm, bn, wm * wn, stages)
    tiles = k // 2 // tm4.A8_PREP_TILE
    assert plan.prep_ksplit * plan.prep_tiles >= tiles > (plan.prep_ksplit - 1) * plan.prep_tiles
    assert plan.prep_row_blocks * tm4.A8_PREP_ROWS >= m
    # the wide tile serves the wide shapes, the narrow one k/v (N = 512)
    assert plan.tile == (1 if name == "k_v" else 0)


def test_plan_by_hand():
    # gate/up at M = 1664: 13 x 148 tiles of 128 x 128, three stages of
    # (128 + 128) x 128 bytes; the prep: 208 row blocks of 8 rows, 296
    # column slices of 64 over all 28 tiles of 64 packed rows
    plan = tm4.plan_int4_a8(1664, 3584, 18944)
    assert plan == tm4.A8Plan(0, 128, 128, 8, 3, 3 * 256 * 128, 13, 148, 208, 1, 28)
    # k/v: the 64 x 64 tile (26 x 8 = 208 blocks against the wide tile's 52),
    # and the prep splits K into 28 single tiles over 8 column slices
    plan = tm4.plan_int4_a8(1664, 3584, 512)
    assert plan == tm4.A8Plan(1, 64, 64, 4, 3, 3 * 128 * 128, 26, 8, 208, 28, 1)
    # down at the resume layers' M = 256: the narrow tile (4 x 56 blocks
    # against 2 x 28); 56 column slices, K split 5 ways in 30 tiles (148)
    plan = tm4.plan_int4_a8(256, 18944, 3584)
    assert (plan.tile, plan.blocks, plan.prep_ksplit, plan.prep_tiles) == (1, 224, 5, 30)


def test_plan_takes_a_swapped_tile_rule(monkeypatch):
    """The tile A/B tool replaces ``a8_tile`` for its run: the plan follows
    it (the wide tile at k/v gives the 52 blocks the rule avoids) and
    refuses a tile that does not divide N."""
    tm4.plan_int4_a8.cache_clear()
    monkeypatch.setattr(tm4, "a8_tile", lambda m, k, n: 0)
    try:
        assert tm4.plan_int4_a8(1664, 3584, 512).blocks == 52
        with pytest.raises(ValueError):
            tm4.plan_int4_a8(256, 3584, 192)  # 128 does not divide 192
    finally:
        tm4.plan_int4_a8.cache_clear()


@pytest.mark.parametrize("m,k,n", [
    (0, 3584, 512),          # no rows
    (256, 3584 + 64, 512),   # K is no multiple of two prep tiles
    (256, 3584, 500),        # N is no multiple of the prep's 64 columns
    (256, 0, 512),           # no K
])
def test_plan_raises_on_refused_shape(m, k, n):
    with pytest.raises(ValueError):
        tm4.plan_int4_a8(m, k, n)


def _source():
    return (CSRC / "int4_matmul.cu").read_text()


def _ints(pattern):
    return tuple(int(x) for x in re.search(pattern, _source()).groups())


# The plan mirrors constants that the kernels are built with; the C
# launcher refuses a plan whose shared-memory bytes, grid or prep split
# disagree, and these cases catch a constant edited on one side only before
# a card is involved.
def test_a8_prep_constants_match_kernel_source():
    found = _ints(r"constexpr int kPrepThreads = (\d+);\nconstexpr int kPrepRows = (\d+);\n"
                  r"constexpr int kPrepCols = (\d+);\nconstexpr int kPrepTile = (\d+);")
    assert found == (256, tm4.A8_PREP_ROWS, tm4.A8_PREP_COLS, tm4.A8_PREP_TILE)


def test_a8_tiles_and_smem_formula_match_kernel_source():
    line = re.search(r"#define GP_A8_TILES\(X\) (.*)", _source()).group(1)
    found = [tuple(int(v) for v in t) for t in
             re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", line)]
    assert [f[0] for f in found] == list(range(len(tm4.A8_TILES)))
    assert tuple(f[1:] for f in found) == tm4.A8_TILES
    assert re.search(r"int smem_bytes\(int bm, int bn, int bk, int stages\) \{ return stages \* "
                     r"\(bm \+ bn\) \* bk; \}", _source())
    for i, (bm, bn, _, _, bk, stages) in enumerate(tm4.A8_TILES):
        assert tm4.a8_smem_bytes(i) == stages * (bm + bn) * bk

"""K5's two stages on the CPU (glimpseprune_torch/ops/cuda/int4_matmul.py):
the plain prep and GEMM composed against ``int4_prefill_a16_reference``,
the prep's W16^T against the JAX package's dequantization arithmetic bit
for bit, and the host plan ``plan_int4_a16`` against the card's limits and
the constants of csrc/int4_matmul.cu, which the C launcher holds a plan to.
On the card chip_smoke.py holds the kernels to these plain versions."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_int4_matmul import SHAPES

from glimpseprune_tpu import quantization as jq
from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.ops.cuda import build
from glimpseprune_torch.ops.cuda import int4_matmul as tm4

CSRC = Path(tm4.__file__).resolve().parents[2] / "csrc"
CONFIG = Path(__file__).resolve().parents[1] / "configs" / "model_qwen2_5_7b_gp"


def _packed(seed, k, n):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    tree = jq.quantize_int4({"text": {"layers": {"l0": {"kernel": jnp.asarray(w)}}}})
    leaf = tree["text"]["layers"]["l0"]
    return np.array(leaf["kernel_q4"]), np.array(leaf["kernel_scale4"])


@pytest.mark.parametrize("m,k,n", [(129, 256, 128), (256, 512, 256), (1662, 256, 128)])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_a16_stages_compose_to_reference(m, k, n, x_dtype):
    """prep then GEMM equals the one-piece plain version in fp32 (the two
    products differ only in the order of fp32 sums: 1e-6), and the CPU path
    of matmul_int4_prefill is the one-piece version (a ragged M included)."""
    packed, scales = (torch.as_tensor(a) for a in _packed(m, k, n))
    x = torch.as_tensor(np.random.default_rng(m + k).standard_normal((m, k)),
                        dtype=torch.float32).to(x_dtype)
    w16t = tm4.int4_a16_prep_reference(packed, scales, x_dtype)
    got = tm4.bf16_gemm_tn_reference(x, w16t, torch.float32)
    want = tm4.int4_prefill_a16_reference(x, packed, scales, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    cpu = tm4.matmul_int4_prefill(x, packed, scales, torch.float32, a8=False)
    assert torch.equal(cpu, want)


def _jax_weights(packed, scales):
    """W4A16's weights as ``_kernel_prefill_a16`` computes them (JAX
    :201-206): the nibbles sign-extended by shifts, times the row's group
    scale in fp32, rounded to bf16; [K, N]."""
    k = 2 * packed.shape[0]
    g = k // scales.shape[0]
    p32 = jnp.asarray(packed).astype(jnp.int32)
    lo = jnp.right_shift(jnp.left_shift(p32, 28), 28).astype(jnp.float32)
    hi = jnp.right_shift(p32, 4).astype(jnp.float32)
    rows = jnp.repeat(jnp.asarray(scales), g, axis=0)
    return jnp.concatenate([(lo * rows[:k // 2]).astype(jnp.bfloat16),
                            (hi * rows[k // 2:]).astype(jnp.bfloat16)])


def _bits(a):
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("k,n,g,seed", [(256, 128, 64, 0), (1024, 256, 128, 1),
                                        (512, 192, 256, 2)])
def test_a16_prep_matches_jax_arithmetic(k, n, g, seed):
    """Every byte value (both nibbles, -8 to 7) against scales drawn at
    random and scales at, just above and just below a bf16 rounding tie
    (1 + 2^-8 is halfway between 1 and 1 + 2^-7; times a power of two it
    stays a tie): W16^T equals JAX's weights transposed, bit for bit."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(-128, 128, (k // 2, n), dtype=np.int64).astype(np.int8)
    packed[:16, :16] = np.arange(256, dtype=np.int64).reshape(16, 16).astype(np.int8)
    scales = rng.uniform(1e-3, 2e-2, (k // g, n)).astype(np.float32)
    tie = np.float32(1 + 2 ** -8)
    scales[:, 0] = tie
    scales[:, 1] = np.nextafter(tie, np.float32(2))
    scales[:, 2] = np.nextafter(tie, np.float32(0))
    scales[0, 3], scales[-1, 3] = tie * np.float32(0.25), tie  # a lo and a hi group
    w16t = tm4.int4_a16_prep_reference(torch.as_tensor(packed), torch.as_tensor(scales))
    assert w16t.shape == (n, k) and w16t.dtype == torch.bfloat16 and w16t.is_contiguous()
    want = _jax_weights(packed, scales)
    np.testing.assert_array_equal(_bits(w16t.t().contiguous().view(torch.int16).numpy()),
                                  _bits(np.asarray(want).view(np.int16)))
    # the ties were met: q = 1 at the tie scale rounds to even (1.0), just
    # above it up (1 + 2^-7), just below it down
    w = np.asarray(want.astype(jnp.float32))[:k // 2]
    q_lo = packed.astype(np.int32) << 28 >> 28
    for col, value in ((0, 1.0), (1, 1 + 2 ** -7), (2, 1.0)):
        rows = q_lo[:, col] == 1
        assert rows.any() and (w[rows, col] == value).all()


def _decoder_shapes():
    t = ModelConfig.load(str(CONFIG)).text
    kv = t.num_key_value_heads * t.head_dim
    return {"q_o": (t.hidden_size, t.hidden_size), "k_v": (t.hidden_size, kv),
            "gate_up": (t.hidden_size, t.intermediate_size),
            "down": (t.intermediate_size, t.hidden_size)}


@pytest.mark.parametrize("m", [129, 831, 1662, 1664])
@pytest.mark.parametrize("name", ["q_o", "k_v", "gate_up", "down"])
def test_a16_plan_fills_the_card(name, m):
    """At the 7B decoder shapes, the smoke's prefill M (1664, the unpruned
    prefill's ragged 1662, a row of it, 831) and the smallest prefill M
    (129): the GEMM's grid has two blocks per SM or takes the narrow tile,
    the prep's grid fills the 132 SMs, and a block's shared memory stays
    within 227 KB, two blocks an SM for the wide tile."""
    k, n = _decoder_shapes()[name]
    plan = tm4.plan_int4_a16(m, k, n)
    assert plan.blocks >= tm4.A16_MIN_BLOCKS or plan.tile == len(tm4.A16_TILES) - 1
    assert plan.prep_blocks >= tm4.SMS
    assert plan.smem_bytes <= build.SMEM_LIMIT == 227 * 1024
    if plan.tile == 0:
        assert 2 * plan.smem_bytes <= build.SMEM_LIMIT
    assert plan.grid_m * plan.bm >= m > (plan.grid_m - 1) * plan.bm
    assert plan.grid_n * plan.bn == n
    bm, bn, wm, wn, _, stages = tm4.A16_TILES[plan.tile]
    assert (plan.bm, plan.bn, plan.warps, plan.stages) == (bm, bn, wm * wn, stages)
    tiles = k // 2 // tm4.A16_PREP_TILE
    assert plan.prep_ksplit * plan.prep_tiles >= tiles > (plan.prep_ksplit - 1) * plan.prep_tiles


WIDE = (0, 128, 128, 8, 3, 3 * 256 * 128)
NARROW = (1, 64, 64, 4, 3, 3 * 128 * 128)


@pytest.mark.parametrize("m,k,n,plan", [
    # q/o: 13 x 28 = 364 wide tiles; the prep's 56 column slices split K
    # toward 8 x 132 blocks: 14 ways in 2 of its 28 tiles of 64 packed rows
    (1664, 3584, 3584, WIDE + (13, 28, 14, 2)),
    # k/v: the 64 x 64 tile (26 x 8 = 208 blocks against the wide tile's
    # 52); 8 column slices, K split into its 28 single tiles
    (1664, 3584, 512, NARROW + (26, 8, 28, 1)),
    # gate/up: 13 x 148; 296 column slices, K split 4 ways in 7 tiles
    (1664, 3584, 18944, WIDE + (13, 148, 4, 7)),
    # down: 13 x 28; 56 column slices, K split 19 ways in 8 of 148 tiles
    (1664, 18944, 3584, WIDE + (13, 28, 19, 8)),
    # the ViT's qkv (K = 1280, which JAX tiles with bkp = 128) over batch
    # (a)'s 5120 window-padded patches: 40 x 30; 60 slices x 10 single tiles
    (5120, 1280, 3840, WIDE + (40, 30, 10, 1)),
])
def test_a16_plan_by_hand(m, k, n, plan):
    assert tm4.plan_int4_a16(m, k, n) == tm4.A16Plan(*plan)


@pytest.mark.parametrize("m,k,n", [
    (0, 3584, 512),          # no rows
    (256, 3584 + 64, 512),   # K is no multiple of two prep tiles
    (256, 3584, 500),        # N is no multiple of the prep's 64 columns
    (256, 0, 512),           # no K
    (256, 3584, 0),          # no N
])
def test_a16_plan_raises_on_refused_shape(m, k, n):
    with pytest.raises(ValueError):
        tm4.plan_int4_a16(m, k, n)


@pytest.mark.parametrize("m,k,n,g", [s for s in SHAPES if tm4.prefill_applicable(*s)])
def test_a16_plan_takes_every_admitted_shape(m, k, n, g):
    """Every shape of the gate table that the prefill gate admits has a
    plan that the C launcher accepts: g a multiple of the prep's tile, K of
    2g, the GEMM tile dividing N and 2K bytes, the prep split covering K."""
    plan = tm4.plan_int4_a16(m, k, n)
    assert g % tm4.A16_PREP_TILE == 0 and k % (2 * g) == 0
    _, bn, _, _, bk, _ = tm4.A16_TILES[plan.tile]
    assert n % bn == 0 and 2 * k % bk == 0 and plan.smem_bytes == tm4.a16_smem_bytes(plan.tile)
    tiles = k // 2 // tm4.A16_PREP_TILE
    assert plan.prep_ksplit * plan.prep_tiles >= tiles > (plan.prep_ksplit - 1) * plan.prep_tiles


def _k5_source():
    src = (CSRC / "int4_matmul.cu").read_text()
    return src[src.index("namespace k5 {"):src.index("}  // namespace k5")]


# The plan mirrors constants that the kernels are built with; the C
# launcher refuses a plan whose shared-memory bytes, grid or prep split
# disagree, and these cases catch a constant edited on one side only before
# a card is involved.
def test_a16_prep_constants_match_kernel_source():
    found = tuple(int(x) for x in re.search(
        r"constexpr int kPrepThreads = (\d+);\nconstexpr int kPrepCols = (\d+);\n"
        r"constexpr int kPrepTile = (\d+);", _k5_source()).groups())
    assert found == (256, tm4.A16_PREP_COLS, tm4.A16_PREP_TILE)


def test_a16_tiles_and_smem_formula_match_kernel_source():
    line = re.search(r"#define GP_A16_TILES\(X\) (.*)", _k5_source()).group(1)
    found = [tuple(int(v) for v in t) for t in
             re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", line)]
    assert [f[0] for f in found] == list(range(len(tm4.A16_TILES)))
    assert tuple(f[1:] for f in found) == tm4.A16_TILES
    assert re.search(r"int smem_bytes\(int bm, int bn, int bk, int stages\) \{ return stages \* "
                     r"\(bm \+ bn\) \* bk; \}", _k5_source())
    for i, (bm, bn, _, _, bk, stages) in enumerate(tm4.A16_TILES):
        assert tm4.a16_smem_bytes(i) == stages * (bm + bn) * bk

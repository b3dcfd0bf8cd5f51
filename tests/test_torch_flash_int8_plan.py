"""K7's host side (glimpseprune_torch/ops/cuda/flash_attention.py), computed
without a card: the plan of the int8 attention kernel (padded head dims,
tiles, shared-memory bytes) against the H100's 227 KB per block at every
config's head dims and against the constants and formulas of
csrc/flash_attention.cu (namespace i8), which the C launcher holds a plan
to; refused shapes raising before any launch; and a lane-level emulation
of the int8 PV product: the score registers packed four to a register as
the A operand of mma.m16n8k32 and V8^T read by ldmatrix in the prep's key
order (``k7_key_order``) give round(p * 127) @ v8 exactly, where the
natural key order does not. On the card chip_smoke.py holds the kernels
to their plain versions."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from glimpseprune_torch.config import ModelConfig, tiny_test_config
from glimpseprune_torch.ops.cuda import build, flash_attention as fa

CSRC = Path(fa.__file__).resolve().parents[2] / "csrc"
CONFIGS = sorted(p.parent.name for p in
                 (Path(__file__).resolve().parents[1] / "configs").glob("model_*/config.json"))


def _config(name):
    if name == "tiny":
        return tiny_test_config()
    return ModelConfig.load(str(Path(__file__).resolve().parents[1] / "configs" / name))


def _i8_source():
    """csrc/flash_attention.cu's int8 kernels (namespace i8)."""
    src = (CSRC / "flash_attention.cu").read_text()
    return src[src.index("namespace i8 {"):src.index("}  // namespace i8")]


@pytest.mark.parametrize("name", CONFIGS + ["tiny"])
@pytest.mark.parametrize("site", ["vit", "llm"])
@pytest.mark.parametrize("pv_int8", [False, True])
def test_int8_plan_fits_every_config(name, site, pv_int8):
    cfg = _config(name)
    tower = cfg.vision if site == "vit" else cfg.text
    heads = tower.num_heads if site == "vit" else tower.num_attention_heads
    d = tower.hidden_size // heads
    for skv in (1, 23, 832, 5120, 16384):
        plan = fa.plan_flash_int8(d, d, skv, pv_int8)
        assert (plan.dqk_pad, plan.dv_pad) in fa.I8_DIMS
        assert plan.dqk_pad >= d and plan.dv_pad >= d
        assert plan.dqk_pad % 32 == 0 and plan.dv_pad % 16 == 0  # mma.m16n8k32 depth; n8 pairs
        assert plan.smem_bytes <= build.SMEM_LIMIT == 227 * 1024
        assert plan.block_q == 16 * plan.warps
        # the v-quantization tile is the compute tile, whatever Sq (K9-int8's
        # shards walk the same tiles as the whole sequence)
        assert plan.block_k == fa.KERNEL_BLOCK_K == 64
        assert plan.kv_tiles == -(-skv // 64)


def test_int8_smem_bytes_by_hand():
    # D=80 (the 7B ViT) under pv_int8 at S=5120: six warps, a 96-row q tile
    # and two 64-key k tiles of 96 int8 bytes + 16; two V8^T tiles of 80
    # rows of 64 + 16 bytes and their 80 f32 scales; ints: two stages of key
    # scales and segments, q segments and positions, 8 slots; 16 bytes per
    # k tile (80 tiles)
    assert fa.plan_flash_int8(80, 80, 5120, True).smem_bytes == (
        (96 + 2 * 64) * 112 + 2 * 80 * 80 + 4 * 2 * 80 + 4 * (2 * 2 * 64 + 2 * 96 + 8) + 16 * 80)
    # D=128 (the LLM) without pv_int8 at S=832: four warps, v as bf16 rows of
    # 128 + 8 elements
    plan = fa.plan_flash_int8(128, 128, 832, False)
    assert plan.smem_bytes == (
        (64 + 2 * 64) * 144 + 2 * 2 * 64 * 136 + 4 * (2 * 2 * 64 + 2 * 64 + 8) + 16 * 13)
    # three D=128 blocks fit on an SM (228 KB, 1 KB reserved per block)
    assert 3 * (plan.smem_bytes + 1024) <= 228 * 1024
    # the tiny config's head dims take the smallest pair
    assert (fa.plan_flash_int8(8, 8, 23, True).dqk_pad, fa.plan_flash_int8(16, 16, 23, True)
            .dv_pad) == (32, 16)


@pytest.mark.parametrize("dqk,dv,skv,why", [
    (300, 64, 64, "unsupported head dims"),
    (64, 200, 64, "unsupported head dims"),
    (0, 64, 64, "unsupported head dims"),
    (128, 128, 1_000_000, "shared memory"),
])
@pytest.mark.parametrize("pv_int8", [False, True])
def test_int8_plan_raises_on_refused_shape(dqk, dv, skv, why, pv_int8):
    with pytest.raises(ValueError, match=why):
        fa.plan_flash_int8(dqk, dv, skv, pv_int8)


@pytest.mark.parametrize("dqk,dv,skv,dtype,why", [
    (300, 64, 64, torch.bfloat16, "unsupported head dims"),
    (64, 200, 64, torch.bfloat16, "unsupported head dims"),
    (64, 64, 64, torch.float32, "must be bf16"),
])
def test_int8_kernels_raise_before_launch(dqk, dv, skv, dtype, why):
    """The card's entry refuses a shape or dtype before it builds or launches
    anything (these tensors lie on the CPU, where no kernel could run)."""
    q = torch.zeros((1, 2, 16, dqk), dtype=dtype)
    k = torch.zeros((1, 1, skv, dqk), dtype=dtype)
    v = torch.zeros((1, 1, skv, dv), dtype=dtype)
    with pytest.raises(ValueError, match=why):
        fa.flash_attention_int8_kernels(q, k, v, None, None, False, True, True)


def _ints(pattern, src):
    return tuple(int(x) for x in re.search(pattern, src).groups())


# The plan mirrors tables and constants that the kernel is built with; the
# C launcher refuses a launch whose shared-memory bytes or prep blocks
# disagree, and these cases catch one side edited alone before a card is
# involved.
@pytest.mark.parametrize("what,python,pattern", [
    pytest.param("head dims", fa.I8_DIMS, r"GP_I8_CASE\((\d+), (\d+)\)\n", id="dims"),
    pytest.param("k tile and stages", (fa.KERNEL_BLOCK_K, fa.I8_STAGES),
                 r"constexpr int kBK = (\d+);[^\n]*\nconstexpr int kStages = (\d+);", id="tiles"),
    pytest.param("warps", (96, fa.i8_warps(96), fa.i8_warps(128)),
                 r"warps_for\(int dqp\) \{ return dqp <= (\d+) \? (\d+) : (\d+); \}", id="warps"),
    pytest.param("prep threads and passes", (fa.I8_PREP_THREADS, fa.I8_PREP_PASSES),
                 r"constexpr int kPrepThreads = (\d+);[^\n]*\nconstexpr int kPasses = (\d+);",
                 id="prep-passes"),
])
def test_int8_plan_matches_kernel_source(what, python, pattern):
    src = _i8_source()
    if what == "head dims":
        found = tuple(tuple(int(x) for x in f) for f in re.findall(pattern, src))
    else:
        found = _ints(pattern, src)
    assert found == python, what


def _ternaries(expr):
    """A chain ``a ? b : c ? d : e`` (no ternary inside b or d) as Python."""
    if " ? " not in expr:
        return expr
    cond, rest = expr.split(" ? ", 1)
    then, rest = rest.split(" : ", 1)
    return f"({then}) if ({cond}) else ({_ternaries(rest)})"


def _c_expr(src, name):
    """The body of a one-expression constexpr function of the source, as a
    Python expression: ``(a ? b : c)`` in parentheses, or a chain of
    ternaries at the top."""
    body = re.search(name + r"\([^)]*\) \{\s*return (.*?);\n\}", src, re.S).group(1)
    body = re.sub(r"\((\w+) \? (.*?) : (.*?)\)", r"((\2) if \1 else (\3))", " ".join(body.split()))
    return _ternaries(body)


def test_int8_smem_formula_matches_kernel_source():
    """i8::smem_fixed, evaluated from its source, against i8_smem_bytes at
    every built pair, with and without pv_int8."""
    expr = _c_expr(_i8_source(), "smem_fixed")
    for dqp, dvp in fa.I8_DIMS:
        for pv8 in (False, True):
            c_bytes = eval(expr, {"warps_for": fa.i8_warps, "kStages": fa.I8_STAGES,
                                  "kBK": fa.KERNEL_BLOCK_K, "dqp": dqp, "dvp": dvp, "pv8": pv8})
            assert fa.i8_smem_bytes(dqp, dvp, pv8, 0) == c_bytes
            assert fa.i8_smem_bytes(dqp, dvp, pv8, 130) == c_bytes + 16 * 3


def test_prep_rows_match_kernel_source():
    """i8::row_lanes and i8::prep_rows, evaluated from their source, against
    i8_prep_rows at every padded qk head dim: the launcher refuses a call
    whose prep blocks disagree. A row's lanes cover its padded bytes."""
    src = _i8_source()
    lanes, rows = _c_expr(src, "row_lanes"), _c_expr(src, "prep_rows")
    for dqp, _ in fa.I8_DIMS:
        n_lanes = eval(lanes, {"dp": dqp})
        assert 8 * n_lanes >= dqp and 32 % n_lanes == 0
        c_rows = eval(rows, {"kPasses": fa.I8_PREP_PASSES, "kPrepThreads": fa.I8_PREP_THREADS,
                             "row_lanes": lambda dp: eval(lanes, {"dp": dp}), "dp": dqp})
        assert fa.i8_prep_rows(dqp) == c_rows


def test_key_order_matches_kernel_source():
    """i8::key_at, evaluated from its source, is k7_key_order, a permutation
    of each 32-key group."""
    expr = _c_expr(_i8_source(), "key_at")
    order = fa.k7_key_order()
    assert [eval(expr, {"pos": p}) for p in range(32)] == order.tolist()
    assert sorted(order.tolist()) == list(range(32))


# ---- a lane-level emulation of the kernel's int8 PV product

_MAGIC = np.float32(12582912.0)  # 1.5 * 2^23


def _rint_byte(y: np.ndarray) -> np.ndarray:
    """pack_p8's rounding of y = p * 127 (fp32): y + 1.5 * 2^23 in fp32,
    whose low mantissa byte is the integer."""
    return ((y.astype(np.float32) + _MAGIC).view(np.uint32) & 0xFF).astype(np.int64)


def test_p8_rounding_exact():
    """pack_p8's rounding through 1.5 * 2^23 is rint(p * 127), half to even:
    tried at every half step and its four fp32 neighbours on each side, at
    every integer and at a million random probabilities."""
    half = np.arange(128, dtype=np.float32) + np.float32(0.5)
    near = [half]
    lo = hi = half
    for _ in range(4):
        lo, hi = np.nextafter(lo, np.float32(0)), np.nextafter(hi, np.float32(200))
        near += [lo, hi]
    p = np.random.default_rng(0).random(1_000_000, dtype=np.float32)
    y = np.concatenate(near + [np.arange(128, dtype=np.float32), p * np.float32(127)])
    y = y[y <= 127]
    np.testing.assert_array_equal(_rint_byte(y), np.rint(y).astype(np.int64))

def _word(bytes4) -> int:
    return int.from_bytes(np.asarray(bytes4, np.int8).tobytes(), "little")


def _bytes(word: int) -> np.ndarray:
    return np.frombuffer(int(word).to_bytes(4, "little"), np.int8).astype(np.int64)


def _ldmatrix_x4(smem: np.ndarray, row_addr) -> np.ndarray:
    """ldmatrix.sync.m8n8.x4.b16 on shared bytes: lane l gives the address
    of row l % 8 of matrix l // 8 (16 bytes); lane l receives, from each
    matrix m, the 32-bit word l % 4 of its row l // 4 -> [32, 4] words."""
    out = np.zeros((32, 4), np.int64)
    for m in range(4):
        for lane in range(32):
            addr = row_addr[8 * m + lane // 4] + 4 * (lane % 4)
            out[lane, m] = _word(smem[addr:addr + 4])
    return out


def _mma_m16n8k32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mma.sync.m16n8k32 s8 (PTX ISA fragment layouts, g = lane / 4,
    t = lane % 4): A 16x32 a0 = (g, 4t..4t+3), a1 = (g+8, 4t..), a2 =
    (g, 16+4t..), a3 = (g+8, 16+4t..); B 32x8 b0 = (4t..4t+3, g), b1 =
    (16+4t.., g); C 16x8 c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..).
    a [32, 4], b [32, 2] words -> c [32, 4] int64."""
    A, B = np.zeros((16, 32), np.int64), np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for r, (row, k0) in enumerate(((g, 4 * t), (g + 8, 4 * t), (g, 16 + 4 * t),
                                       (g + 8, 16 + 4 * t))):
            A[row, k0:k0 + 4] = _bytes(a[lane, r])
        for r, k0 in enumerate((4 * t, 16 + 4 * t)):
            B[k0:k0 + 4, g] = _bytes(b[lane, r])
    D = A @ B
    return np.array([[D[lane // 4, 2 * (lane % 4)], D[lane // 4, 2 * (lane % 4) + 1],
                      D[lane // 4 + 8, 2 * (lane % 4)], D[lane // 4 + 8, 2 * (lane % 4) + 1]]
                     for lane in range(32)])


def _kernel_pv(p: np.ndarray, v8t_tile: np.ndarray) -> np.ndarray:
    """One warp's int32 PV sums over one 64-key tile as attn_kernel<.., true>
    forms them: p [16, 64] fp32 probabilities in the S accumulators' layout
    (thread (g, t) holds rows g, g + 8, keys 8n + 2t, 8n + 2t + 1 of n8 tile
    n), packed by pack_p8 into the A operand of each 32-key step; the V8^T
    tile [dvp, 64] in shared memory with rows of 64 + 16 bytes, read by the
    kernel's ldmatrix addresses -> [16, dvp]."""
    dvp = v8t_tile.shape[0]
    ldt = 64 + 16
    smem = np.zeros(dvp * ldt, np.int8)
    for r in range(dvp):
        smem[r * ldt:r * ldt + 64] = v8t_tile[r]
    q = _rint_byte(p.astype(np.float32) * np.float32(127))  # pack_p8's rounding
    s = np.zeros((32, 8, 4), np.int64)  # the score registers, after rint(p * 127)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for n in range(8):
            for e in range(4):
                s[lane, n, e] = q[g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1)]
    pa = np.zeros((2, 32, 4), np.int64)
    for kk in range(2):
        n = 4 * kk
        for lane in range(32):
            r = s[lane]
            pa[kk, lane] = [_word([r[n][0], r[n][1], r[n + 1][0], r[n + 1][1]]),
                            _word([r[n][2], r[n][3], r[n + 1][2], r[n + 1][3]]),
                            _word([r[n + 2][0], r[n + 2][1], r[n + 3][0], r[n + 3][1]]),
                            _word([r[n + 2][2], r[n + 2][3], r[n + 3][2], r[n + 3][3]])]
    out = np.zeros((16, dvp), np.int64)
    for np_ in range(dvp // 16):
        pv = [np.zeros((32, 4), np.int64), np.zeros((32, 4), np.int64)]
        for kk in range(2):
            addr = [(np_ * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldt
                    + (2 * kk + ((lane >> 3) & 1)) * 16 for lane in range(32)]
            bf = _ldmatrix_x4(smem, addr)
            pv[0] += _mma_m16n8k32(pa[kk], bf[:, [0, 1]])
            pv[1] += _mma_m16n8k32(pa[kk], bf[:, [2, 3]])
        for jj in range(2):
            n = 2 * np_ + jj
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for e in range(4):
                    out[g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1)] = pv[jj][lane, e]
    return out


@pytest.mark.parametrize("dv,seed", [(80, 0), (16, 1)])
def test_pv8_register_packing_and_key_order_exact(dv, seed):
    """The emulated product over the plain prep's V8^T tile equals
    round(p * 127) @ v8 of the tile's natural key order exactly (the int32
    sum does not depend on the order of its terms); V8^T in the natural key
    order, the control, gives another product."""
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal((1, 1, 64, dv)).astype(np.float32)).bfloat16()
    q = torch.zeros((1, 1, 1, 16), dtype=torch.bfloat16)
    _, _, _, _, v8t, _ = fa.flash_int8_prep_reference(q, q, v, True)
    tile = v8t[0, 0, 0].numpy()                            # [dv_pad, 64], prep's key order
    v8, _ = fa.quantize_v_tile(v.float()[0, 0])            # [64, dv], natural order
    p = rng.random((16, 64), dtype=np.float32)
    p[rng.random((16, 64)) < 0.2] = 0.0                   # masked keys
    p[3] = 0.0                                             # a row with no key
    want = np.rint(p * np.float32(127)).astype(np.int64) @ v8.numpy().astype(np.int64)
    got = _kernel_pv(p, tile)
    np.testing.assert_array_equal(got[:, :dv], want)
    assert not got[:, dv:].any()  # pad columns of V8^T are zero
    natural = v8.numpy().astype(np.int8).T                 # [dv, 64], keys in order
    control = _kernel_pv(p, np.pad(natural, ((0, tile.shape[0] - dv), (0, 0))))
    assert not np.array_equal(control[:, :dv], want)

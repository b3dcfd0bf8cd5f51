"""K4, the int4 decode product, on the CPU (glimpseprune_torch/ops/cuda/
int4_matmul.py): the host plan ``plan_int4_decode`` against the card's
limits and the constants of csrc/int4_matmul.cu, which the C launcher holds
a plan to; and a test-local emulation of the kernel's arithmetic (int4
values exact in bf16, fp32 partial dots per 64-row group, each scaled at
its group's end, the K splits' sums added in rank order) against
``matmul_int4_reference`` and the Pallas kernel in interpret mode. On the
card chip_smoke.py holds the kernel to the plain version."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glimpseprune_tpu.ops.pallas.int4_matmul as jm4
from glimpseprune_tpu import quantization as jq
from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.ops.cuda import build
from glimpseprune_torch.ops.cuda import int4_matmul as tm4

CSRC = Path(tm4.__file__).resolve().parents[2] / "csrc"
CONFIG = Path(__file__).resolve().parents[1] / "configs" / "model_qwen2_5_7b_gp"
# chip_smoke.py's limit for K4 against its plain version: bf16 output
# rounding (at most 2**-8 of max |ref|) plus fp32 summation order
INT4_RTOL = 4e-3


def _decoder_shapes():
    t = ModelConfig.load(str(CONFIG)).text
    kv = t.num_key_value_heads * t.head_dim
    return {"q_o": (t.hidden_size, t.hidden_size), "k_v": (t.hidden_size, kv),
            "gate_up": (t.hidden_size, t.intermediate_size),
            "down": (t.intermediate_size, t.hidden_size),
            "head": (t.hidden_size, t.vocab_size)}


@pytest.mark.parametrize("m", [1, 2, 128])
@pytest.mark.parametrize("name", ["q_o", "k_v", "gate_up", "down", "head"])
def test_plan_fills_the_card(name, m):
    """At the 7B's decode shapes the grid has a block for each of the 132
    SMs, the K split covers K/2 in whole packed groups with none empty, a
    cluster holds the split, and a block's shared memory fits 227 KB."""
    k, n = _decoder_shapes()[name]
    plan = tm4.plan_int4_decode(m, k, n)
    groups = k // 2 // tm4.K4_GROUP_ROWS
    assert plan.grid >= tm4.SMS == 132
    assert plan.ksplit * plan.groups_per_split >= groups
    assert (plan.ksplit - 1) * plan.groups_per_split < groups
    assert 1 <= plan.ksplit <= tm4.K4_MAX_CLUSTER == 8  # one cluster holds the split
    assert plan.grid == n // plan.bn * plan.ksplit and n % plan.bn == 0
    assert plan.mpad >= m
    assert plan.smem_bytes <= build.SMEM_LIMIT == 227 * 1024
    assert plan.stages == tm4.K4_STAGES


@pytest.mark.parametrize("m,k,n,want", [
    # q/o: 28 column tiles of 128, K split 7 ways in 4 groups (196 blocks)
    (2, 3584, 3584, (0, 128, 8, 4, 7, 4, 4 * (64 * 128 + 8 * 128 + 256 * 8), 196)),
    # k/v: 128 columns give 28 blocks, so 16 columns a block (one warp)
    (1, 3584, 512, (1, 16, 8, 1, 7, 4, 4 * (64 * 16 + 8 * 16 + 256 * 8), 224)),
    # gate/up: 148 column tiles, K split 4 ways (592 blocks)
    (2, 3584, 18944, (0, 128, 8, 4, 4, 7, 4 * (64 * 128 + 8 * 128 + 256 * 8), 592)),
    # down: 148 packed groups in 8 splits of 19, 28 column tiles
    (1, 18944, 3584, (0, 128, 8, 4, 8, 19, 4 * (64 * 128 + 8 * 128 + 256 * 8), 224)),
    # the head: 1188 column tiles, no split
    (2, 3584, 152064, (0, 128, 8, 4, 1, 28, 4 * (64 * 128 + 8 * 128 + 256 * 8), 1188)),
    # M = 128: 16 slices of 8 rows over 4 warps along M, 32 columns a block
    (128, 3584, 18944, (8, 32, 128, 4, 1, 28, 4 * (64 * 32 + 8 * 32 + 256 * 128), 592)),
    (9, 3584, 512, (3, 16, 16, 1, 7, 4, 4 * (64 * 16 + 8 * 16 + 256 * 16), 224)),
])
def test_plan_by_hand(m, k, n, want):
    plan = tm4.plan_int4_decode(m, k, n)
    assert (plan.tile, plan.bn, plan.mpad, plan.warps, plan.ksplit, plan.groups_per_split,
            plan.smem_bytes, plan.grid) == want
    assert tuple(plan.args) == (m, k, n, plan.tile, plan.smem_bytes, plan.ksplit,
                                plan.groups_per_split, plan.grid, 0)
    assert tuple(tm4.plan_int4_decode(m, k, n, f32=True).args)[-1] == 1
    assert plan.args_ptr == plan.args.buffer_info()[0]
    assert plan.key == tm4.launch_key(k, n)


@pytest.mark.parametrize("name", ["k_v", "gate_up"])
def test_plan_covers_every_m(name):
    """Each M up to 128 takes a tile of its class: enough n8 slices, and no
    class larger than it needs."""
    k, n = _decoder_shapes()[name]
    for m in range(1, 129):
        plan = tm4.plan_int4_decode(m, k, n)
        top, tiles = next(c for c in tm4.K4_CLASSES if m <= c[0])
        assert plan.tile in tiles and plan.mpad == top >= m
        assert plan.grid >= tm4.SMS


@pytest.mark.parametrize("m,k,n", [
    (0, 3584, 512),          # no rows
    (129, 3584, 512),        # past the decode kernel's 128 rows
    (2, 3584 + 64, 512),     # K/2 is no whole number of 64-row groups
    (2, 0, 512),             # no K
    (2, 3584, 0),            # no N
    (2, 3584, 8),            # N under the narrowest tile's 16 columns
])
def test_plan_raises_on_refused_shape(m, k, n):
    with pytest.raises(ValueError):
        tm4.plan_int4_decode(m, k, n)


@pytest.mark.parametrize("m,k,n,g", [
    (129, 1024, 512, 64),    # M past 128
    (2, 1024, 256, 64),      # N no multiple of the Pallas kernel's 512
    (2, 768, 512, 64),       # K no multiple of 512
    (2, 1024, 512, 128),     # group of 128
])
def test_wrapper_raises_off_the_gate(m, k, n, g):
    """The shape gate (JAX :91) holds before any plan or launch."""
    assert not tm4.kernel_applicable(m, k, n, g)
    x = torch.zeros((m, k))
    packed = torch.zeros((k // 2, n), dtype=torch.int8)
    scales = torch.ones((k // g, n))
    with pytest.raises(ValueError):
        tm4.matmul_int4(x, packed, scales)


def _source():
    return (CSRC / "int4_matmul.cu").read_text()


# The plan mirrors constants the kernel is built with; the C launcher
# refuses a plan whose shared-memory bytes, grid or split disagree, and these
# cases catch a constant edited on one side only before a card is involved.
def test_k4_constants_match_kernel_source():
    found = re.search(r"constexpr int kGroupRows = (\d+);\nconstexpr int kStages = (\d+);\n"
                      r"constexpr int kMaxCluster = (\d+);", _source()).groups()
    assert tuple(int(v) for v in found) == (tm4.K4_GROUP_ROWS, tm4.K4_STAGES,
                                            tm4.K4_MAX_CLUSTER)


def test_k4_tiles_and_smem_formula_match_kernel_source():
    src = _source()
    block = re.search(r"#define GP_K4_TILES\(X\)((?:.*\\\n)*.*\n)", src).group(1)
    found = [tuple(int(v) for v in t) for t in
             re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)", block)]
    assert [f[0] for f in found] == list(range(len(tm4.K4_TILES)))
    assert tuple(f[1:] for f in found) == tm4.K4_TILES
    assert "return kGroupRows * bn + 8 * bn + 256 * mpad;" in src
    assert re.search(r"return kStages \* stage_bytes\(bn, mpad\) > 4 \* mpad \* bn \? "
                     r"kStages \* stage_bytes\(bn, mpad\)\s+: 4 \* mpad \* bn;", src)
    assert "constexpr int BN = 16 * TW * WN, MPAD = 8 * SL * WM;" in src
    for i, (sl, wm, wn, tw) in enumerate(tm4.K4_TILES):
        bn, mpad = 16 * tw * wn, 8 * sl * wm
        assert tm4.k4_block(i) == (bn, mpad)
        assert tm4.k4_smem_bytes(i) == max(
            tm4.K4_STAGES * (64 * bn + 8 * bn + 256 * mpad), 4 * mpad * bn)
        # the kernel's copy loops: each thread's weight chunks share one
        # swizzle, and one scale chunk a thread covers both scale rows
        threads, chunks = 32 * wm * wn, bn // 16
        assert threads % chunks == 0 and threads // chunks % 8 == 0 and bn // 2 <= threads


def test_launcher_refuses_a_disagreeing_plan():
    """The C launcher recomputes the tile's shared memory and grid, and the
    split's cover of K/2, and refuses what disagrees (no fallback)."""
    src = _source()
    launch = src[src.index("int launch(const Args& a, int smem, int ksplit"):]
    assert re.search(r"if \(a\.m > MPAD \|\| a\.n % BN != 0 \|\| smem != smem_bytes\(BN, MPAD\) "
                     r"\|\|\s+grid != a\.n / BN \* ksplit\)\s+return \(int\)cudaErrorInvalidValue;",
                     launch)
    entry = src[src.index('extern "C" int int4_decode_bf16('):]
    entry = entry[:entry.index("switch (tile)")]
    for check in ("k % (2 * k4::kGroupRows) != 0", "ksplit > k4::kMaxCluster",
                  "(long)ksplit * per < groups", "(long)(ksplit - 1) * per >= groups", "& 15"):
        assert check in entry


def _packed(seed, k, n):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    tree = jq.quantize_int4({"text": {"layers": {"l0": {"kernel": jnp.asarray(w)}}}})
    leaf = tree["text"]["layers"]["l0"]
    return np.array(leaf["kernel_q4"]), np.array(leaf["kernel_scale4"])


def _emulate(x, packed, scales, plan, drop_last_split=False):
    """K4's arithmetic as the card runs it, in fp32 from x in bf16: the
    int4 values (exact in bf16), per packed group the lo and the hi group's
    partial dots, each times its scale and added at the group's end (one
    rounding, as fmaf), per split in group order; then the splits' sums
    added in rank order. -> fp32 [M, N] before the bf16 rounding."""
    k, n = 2 * packed.shape[0], packed.shape[1]
    rows, kh = tm4.K4_GROUP_ROWS, k // 2
    xf = x.to(torch.bfloat16).float()
    q = tm4.unpack_int4(packed).float()
    s = scales.float()
    groups = kh // rows
    parts = []
    for rank in range(plan.ksplit):
        acc = torch.zeros((x.shape[0], n))
        for gi in range(rank * plan.groups_per_split,
                        min(groups, (rank + 1) * plan.groups_per_split)):
            for half in (0, 1):
                r0 = half * kh + gi * rows
                part = xf[:, r0:r0 + rows] @ q[r0:r0 + rows]
                acc = (part.double() * s[half * groups + gi].double() + acc.double()).float()
        parts.append(acc)
    if drop_last_split:
        parts = parts[:-1]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@pytest.mark.parametrize("m", [1, 2, 9, 16, 128])
def test_emulation_matches_plain_version(m):
    """The kernel's order of operations lands within INT4_RTOL of
    ``matmul_int4_reference`` once both are rounded to bf16, as the card
    is checked; without the last split it does not (the card's control)."""
    k, n = 2048, 512
    packed, scales = (torch.as_tensor(a) for a in _packed(m, k, n))
    x = torch.as_tensor(np.random.default_rng(m + 1).standard_normal((m, k)),
                        dtype=torch.float32).bfloat16()
    plan = tm4.plan_int4_decode(m, k, n)
    assert plan.ksplit > 1
    got = _emulate(x, packed, scales, plan).bfloat16()
    ref = tm4.matmul_int4_reference(x, packed, scales, torch.float32)
    err = ((got.float() - ref).abs().max() / ref.abs().max()).item()
    assert err <= INT4_RTOL
    dropped = _emulate(x, packed, scales, plan, drop_last_split=True).bfloat16()
    assert ((dropped.float() - ref).abs().max() / ref.abs().max()).item() > INT4_RTOL
    # the bf16 path of the CPU wrapper is the plain version
    assert torch.equal(tm4.matmul_int4(x, packed, scales),
                       tm4.matmul_int4_reference(x, packed, scales, torch.bfloat16))


@pytest.mark.parametrize("m", [1, 2, 16])
def test_emulation_matches_pallas(m):
    """fp32 on both sides from the same bf16-valued x: the group partials
    are the same sums in another order (1e-5)."""
    k, n = 1024, 512
    packed, scales = _packed(20 + m, k, n)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    x = torch.as_tensor(x).bfloat16().float().numpy()  # values exact in bf16
    want = np.asarray(jm4.matmul_int4(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
                                      out_dtype=jnp.float32, interpret=True))
    plan = tm4.plan_int4_decode(m, k, n)
    got = _emulate(torch.as_tensor(x), torch.as_tensor(packed), torch.as_tensor(scales), plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,n", [(1, 3584, 18944), (2, 3584, 512), (8, 3584, 3584),
                                   (64, 3584, 18944)])
def test_plan_of_a_column_shard_takes_the_whole_layers_split(m, k, n):
    """A column-parallel shard (n / 2 columns) planned for the whole layer's
    N takes its tile and K split, so each column sums its groups as the
    unsharded layer's does; its grid covers the shard's columns."""
    whole = tm4.plan_int4_decode(m, k, n)
    shard = tm4.plan_int4_decode(m, k, n // 2, n)
    assert (shard.tile, shard.ksplit, shard.groups_per_split) == (
        whole.tile, whole.ksplit, whole.groups_per_split)
    assert shard.grid == n // 2 // shard.bn * shard.ksplit

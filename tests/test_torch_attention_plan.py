"""Host-side plans of the attention kernels (K2's tensor-core forward, K3's
tensor-core backward, K1/K8's window kernel): padded head dims, tiles and
shared-memory bytes, computed without a card. Every head-dim pair the
repo's configs and the tiny config give must fit the H100's 227 KB per
block; the forward's k tile must not
depend on Sq or on where a q shard sits (K9's bit equality with the
monolithic call rests on it), nor the backward's; the backward must take
every shape the forward takes (training never reaches a forward whose
backward is refused); a shape the kernel refuses must raise in the
wrapper's checks, never fall back."""

import re
from pathlib import Path

import pytest
import torch

from glimpseprune_torch.config import ModelConfig, tiny_test_config
from glimpseprune_torch.ops.cuda import build, flash_attention as fa
from glimpseprune_torch.ops.cuda import window_attention as wa

CSRC = Path(fa.__file__).resolve().parents[2] / "csrc"
CONFIGS = sorted(p.parent.name for p in
                 (Path(__file__).resolve().parents[1] / "configs").glob("model_*/config.json"))


def _config(name):
    if name == "tiny":
        return tiny_test_config()
    return ModelConfig.load(str(Path(__file__).resolve().parents[1] / "configs" / name))


def _head_dims(cfg):
    """(ViT, LLM, fuser qk / v) head dims, as the model's call sites form them."""
    v, t, gp = cfg.vision, cfg.text, cfg.gp
    cond = gp.visual_cond_size if len(gp.selected_visual_layers) else 0
    return {"vit": (v.hidden_size // v.num_heads,) * 2,
            "llm": (t.hidden_size // t.num_attention_heads,) * 2,
            "fuser": ((gp.attn_fuse_size + cond) // gp.attn_fuse_num_heads,
                      gp.attn_fuse_size // gp.attn_fuse_num_heads)}


def _window(cfg):
    v = cfg.vision
    return (v.window_size // v.spatial_merge_size // v.patch_size) ** 2 * v.spatial_merge_unit


@pytest.mark.parametrize("name", CONFIGS + ["tiny"])
@pytest.mark.parametrize("site", ["vit", "llm", "fuser"])
def test_flash_plan_fits_every_config(name, site):
    dqk, dv = _head_dims(_config(name))[site]
    for skv in (1, 23, 832, 6144, 16384):
        plan = fa.plan_flash(dqk, dv, skv)
        assert (plan.dqk_pad, plan.dv_pad) in fa.FWD_DIMS
        assert plan.dqk_pad >= dqk and plan.dv_pad >= dv
        assert plan.dqk_pad % 16 == 0 and plan.dv_pad % 16 == 0  # mma depth, two n-tiles
        assert plan.smem_bytes <= build.SMEM_LIMIT == 227 * 1024
        assert plan.block_q == 16 * plan.warps
        # K9's bit equality: the plan sees no Sq or shard offset, and the k
        # tile is the same whatever the sequence length
        assert plan.block_k == fa.FWD_BLOCK_K == 64


@pytest.mark.parametrize("name", CONFIGS + ["tiny"])
@pytest.mark.parametrize("site", ["vit", "llm", "fuser"])
def test_flash_bwd_plan_fits_every_config(name, site):
    dqk, dv = _head_dims(_config(name))[site]
    for sq, skv in ((1, 1), (23, 23), (416, 832), (832, 832), (6144, 6144), (16384, 16384)):
        plan = fa.plan_flash_bwd(dqk, dv, sq, skv)
        assert (plan.dqk_pad, plan.dv_pad) in fa.BWD_DIMS
        assert (plan.dqk_pad, plan.dv_pad) == (fa.plan_flash(dqk, dv, skv).dqk_pad,
                                               fa.plan_flash(dqk, dv, skv).dv_pad)
        assert plan.dqk_pad >= dqk and plan.dv_pad >= dv
        assert plan.dqk_pad % 16 == 0 and plan.dv_pad % 16 == 0  # mma depth, two n-tiles
        assert max(plan.smem_dq, plan.smem_dkv) <= build.SMEM_LIMIT
        # K9's dq bit equality: the k tile is the same whatever Sq
        assert plan.block == fa.BWD_BLOCK == 64 and plan.warps == fa.BWD_WARPS == 4


def test_flash_bwd_smem_bytes_by_hand():
    # D=128 (the LLM) at S=832: the resident q (dq) or k (dkv) tile and a
    # two-stage ring of the streamed one, for each of Dqk and Dv, 64 rows,
    # rows padded by 8 elements; nine 64-entry row vectors and 8 slots; one
    # int per listed tile (13 tiles of 64)
    plan = fa.plan_flash_bwd(128, 128, 832, 832)
    assert plan.smem_dq == plan.smem_dkv == (
        2 * (3 * 64 * 136 + 3 * 64 * 136) + 4 * (9 * 64 + 8) + 4 * 13)
    # the fuser's 192/64 over 770 rows; a K9 shard lists its own q tiles
    assert fa.plan_flash_bwd(192, 64, 770, 770).smem_dq == (
        2 * (3 * 64 * 200 + 3 * 64 * 72) + 4 * (9 * 64 + 8) + 4 * 13)
    shard = fa.plan_flash_bwd(128, 128, 416, 832)
    assert shard.smem_dkv == plan.smem_dkv - 4 * 6 and shard.smem_dq == plan.smem_dq
    # two blocks of either kernel fit on an SM at the LLM's shape (228 KB,
    # 1 KB reserved per block)
    assert 2 * (plan.smem_dkv + 1024) <= 228 * 1024


@pytest.mark.parametrize("dqk,dv", sorted({(d, e) for d in (1, 8, 16, 17, 64, 80, 96, 128, 160,
                                                            192, 200, 256)
                                           for e in (1, 4, 8, 16, 64, 80, 100, 128)}))
def test_flash_bwd_plan_accepts_every_forward_shape(dqk, dv):
    for skv in (1, 64, 832, 16384, 100_000):
        try:
            fwd = fa.plan_flash(dqk, dv, skv)
        except ValueError:
            continue
        bwd = fa.plan_flash_bwd(dqk, dv, skv, skv)
        assert (bwd.dqk_pad, bwd.dv_pad) == (fwd.dqk_pad, fwd.dv_pad)


@pytest.mark.parametrize("dqk,dv,sq,skv,why", [
    (300, 64, 64, 64, "unsupported head dims"),
    (64, 200, 64, 64, "unsupported head dims"),
    (0, 64, 64, 64, "unsupported head dims"),
    (128, 128, 64, 5_000_000, "shared memory"),
    (128, 128, 5_000_000, 64, "shared memory"),
])
def test_flash_bwd_plan_raises_on_refused_shape(dqk, dv, sq, skv, why):
    with pytest.raises(ValueError, match=why):
        fa.plan_flash_bwd(dqk, dv, sq, skv)


@pytest.mark.parametrize("b,hkv,skv,sms,causal,want", [
    (2, 4, 832, 132, True, 6),     # the LLM's causal layers: 104 dkv blocks
    (2, 4, 770, 132, False, 1),    # the fuser: balanced blocks, never split
    (1, 2, 64, 132, True, 8),      # a small causal call: at most BWD_MAX_SPLITS
    (8, 8, 8192, 132, True, 1),    # enough blocks already
    (1, 1, 1024, 132, False, 1),   # 16 balanced blocks: a split only adds workspace
])
def test_bwd_splits(b, hkv, skv, sms, causal, want):
    assert fa.bwd_splits(b, hkv, skv, sms, causal) == want


@pytest.mark.parametrize("name", CONFIGS + ["tiny"])
@pytest.mark.parametrize("rope", [True, False], ids=["K1", "K8"])
def test_window_plan_fits_every_config(name, rope):
    cfg = _config(name)
    dim, _ = _head_dims(cfg)["vit"]
    plan = wa.plan_window(dim, _window(cfg), cfg.vision.num_heads, rope)
    assert plan.dim_pad in wa.WINDOW_DIMS and plan.dim_pad >= dim
    assert cfg.vision.num_heads % plan.heads_per_block == 0
    assert plan.smem_bytes <= build.SMEM_LIMIT


def test_flash_smem_bytes_by_hand():
    # D=80 (the 7B ViT): six warps, a 96-row q tile of its own; two stages
    # of 64-key k and v tiles, rows padded by 8 elements; ints: two stages of
    # key segments, q segments and positions, 8 slots; four per k tile
    assert fa.plan_flash(80, 80, 6144).smem_bytes == (
        2 * (96 * 88 + 2 * 64 * 88 + 2 * 64 * 88) + 4 * (2 * 64 + 2 * 96 + 8) + 16 * 96)
    # D=128 (the LLM): four warps, the 64-row q tile inside the last k stage
    assert fa.plan_flash(128, 128, 832).smem_bytes == (
        2 * (2 * 64 * 136 + 2 * 64 * 136) + 4 * (2 * 64 + 2 * 64 + 8) + 16 * 13)
    # three D=128 blocks fit on an SM (228 KB, 1 KB reserved per block)
    assert 3 * (fa.plan_flash(128, 128, 832).smem_bytes + 1024) <= 228 * 1024


def _forward_source():
    """csrc/flash_attention.cu's tensor-core forward (namespace fwd)."""
    src = (CSRC / "flash_attention.cu").read_text()
    return src[src.index("namespace fwd {"):src.index("}  // namespace fwd")]


def _backward_source():
    return (CSRC / "flash_attention_bwd.cu").read_text()


def _ints(pattern, src):
    return tuple(int(x) for x in re.search(pattern, src).groups())


# The plans mirror tables and constants that the kernel sources are built
# with; the C launchers refuse a launch whose shared-memory bytes disagree,
# and these cases catch a table or constant edited on one side only
# before a card is involved.
@pytest.mark.parametrize("what,python,pattern,source", [
    pytest.param("forward head dims", fa.FWD_DIMS, r"GP_FWD_CASE\((\d+), (\d+)\)",
                 _forward_source, id="forward-dims"),
    pytest.param("forward k tile and stages", (fa.FWD_BLOCK_K, fa.FWD_STAGES),
                 r"constexpr int kBK = (\d+);[^\n]*\nconstexpr int kStages = (\d+);",
                 _forward_source, id="forward-tiles"),
    pytest.param("forward warps", (80, fa.fwd_warps(80), fa.fwd_warps(96)),
                 r"warps_for\(int dqk\) \{ return dqk <= (\d+) \? (\d+) : (\d+); \}",
                 _forward_source, id="forward-warps"),
    pytest.param("backward head dims", fa.BWD_DIMS, r"GP_BWD_CASE\((\d+), (\d+)\)",
                 _backward_source, id="backward-dims"),
    pytest.param("backward tiles, stages and warps", (fa.BWD_BLOCK, fa.BWD_STAGES, fa.BWD_WARPS),
                 r"constexpr int kBK = (\d+);[^\n]*\nconstexpr int kStages = (\d+);[^\n]*\n"
                 r"constexpr int kWarps = (\d+);", _backward_source, id="backward-tiles"),
    pytest.param("window head dims", wa.WINDOW_DIMS, r"case (\d+): return launch_dp<",
                 lambda: (CSRC / "window_attention.cu").read_text(), id="window-dims"),
    pytest.param("window rows", (wa.MAX_WP,), r"constexpr int kWP = (\d+);",
                 lambda: (CSRC / "window_attention.cu").read_text(), id="window-rows"),
])
def test_plan_matches_kernel_source(what, python, pattern, source):
    src = source()
    if what.endswith("head dims"):
        found = re.findall(pattern, src)
        found = tuple(tuple(int(x) for x in f) if isinstance(f, tuple) else int(f)
                      for f in found)
    else:
        found = _ints(pattern, src)
    assert found == python, what


def test_bwd_smem_formula_matches_kernel_source():
    """The C launcher's smem_fixed, evaluated from its source, against
    bwd_smem_bytes at every built pair (the launcher refuses a launch whose
    bytes disagree)."""
    found = _ints(r"return (\d+) \* (\d+) \* kBK \* \(dqk \+ (\d+) \+ dv \+ (\d+)\) \+ "
                  r"(\d+) \* \((\d+) \* kBK \+ (\d+)\);", _backward_source())
    two, three, pad_qk, pad_v, four, nine, slots = found
    for dqk, dv in fa.BWD_DIMS:
        c_bytes = (two * three * fa.BWD_BLOCK * (dqk + pad_qk + dv + pad_v)
                   + four * (nine * fa.BWD_BLOCK + slots))
        assert fa.bwd_smem_bytes(dqk, dv, 0) == c_bytes
        assert fa.bwd_smem_bytes(dqk, dv, 13) == c_bytes + 4 * 13


def _qkv(sq, skv, dqk, dv, hq=4, hkv=2, b=1):
    return (torch.zeros((b, hq, sq, dqk), dtype=torch.bfloat16),
            torch.zeros((b, hkv, 1, dqk), dtype=torch.bfloat16).expand(b, hkv, skv, dqk),
            torch.zeros((b, hkv, 1, dv), dtype=torch.bfloat16).expand(b, hkv, skv, dv))


@pytest.mark.parametrize("dqk,dv,skv,why", [
    (300, 64, 64, "unsupported head dims"),
    (64, 200, 64, "unsupported head dims"),
    (8, 8, 1_000_000, "shared memory"),
])
def test_check_raises_on_refused_shape(dqk, dv, skv, why):
    q, k, v = _qkv(16, skv, dqk, dv)
    with pytest.raises(ValueError, match=why):
        fa._check(q, k, v, None, None, False, True)


def test_check_accepts_main_path_shapes():
    for dqk, dv, sq in [(80, 80, 3072), (128, 128, 832), (192, 64, 768), (8, 4, 37)]:
        q, k, v = _qkv(sq, sq, dqk, dv)
        seg = torch.zeros((1, sq), dtype=torch.int32)
        (qseg_ptr, kseg_ptr, qpos_ptr), _ = fa._check(q, k, v, seg, seg, True, False)
        assert qseg_ptr == seg.data_ptr() and qpos_ptr is None  # int32 ids pass uncopied


@pytest.mark.parametrize("dim,wp,rope", [(130, 64, False), (80, 65, True), (9, 16, True)])
def test_window_plan_raises_on_refused_shape(dim, wp, rope):
    with pytest.raises(ValueError, match="unsupported"):
        wa.plan_window(dim, wp, 16, rope)

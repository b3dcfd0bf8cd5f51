"""The port's kernel sweeps (glimpseprune_torch/tools/sweep_vision_attention.py,
sweep_vit_fullatt.py, i8attn_microbench.py) on the CPU, against the JAX
tools in the repo-root tools/:

- each tool's ``main`` at a tiny size with ``--device cpu`` writes the rows
  and keys a card run writes, "not measured" in every time field;
- section 1's heads-per-block swap covers the divisors of H, reaches the
  launcher's arguments, and restores ``plan_window`` even when the body
  raises;
- section 1b's attention half-block and MLP half in fp32 at P = 256, H = 2,
  D = 16, wp = 16 against the same composition built from the JAX package
  (``glimpseprune_tpu.quantization.matmul_w8a8``, the Pallas
  ``window_attention_fused`` in interpret mode, the JAX tool's own rms),
  within 1e-4 of the largest output. W8A8 rounds each activation row to
  int8, so an fp32 difference of ~1e-7 upstream (the rms, the window
  attention's sums) could move a value across a rounding boundary, one
  int8 step, which moves an output by ~1e-3 of the largest; as in
  tests/test_torch_rows.py each W8A8 product of the port's halves is
  therefore also fed to JAX's ``matmul_w8a8`` on the port's own
  activations (within W8A8_RTOL), and the halves end to end are held to
  1e-4 where no activation rounds the other way, to FLIP_RTOL where one
  does (counted per run);
- ``quantize_int8`` bit for bit against the JAX tool's ``quant`` (its
  source, read from the file) on the tool's own draws;
- the TF/s counts against the JAX tools' formulas (read from their
  source), the bound against its definition, and the tools' q, k, v
  against the JAX tools' draw.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glimpseprune_tpu import quantization as jq
from glimpseprune_tpu.ops.pallas.window_attention import (
    window_attention_fused as pallas_window_fused,
)

from glimpseprune_torch.models import layers
from glimpseprune_torch.ops.cuda import window_attention as wa
from glimpseprune_torch.quantization import quantize_int8
from glimpseprune_torch.tools import i8attn_microbench as i8m
from glimpseprune_torch.tools import kernel_ab as ab
from glimpseprune_torch.tools import sweep_vision_attention as sva
from glimpseprune_torch.tools import sweep_vit_fullatt as sfa

ROOT = Path(__file__).resolve().parents[1]
JAX_TOOLS = ROOT / "tools"
P, H, D, WP, INTER = 256, 2, 16, 16, 48
HALF_RTOL = 1e-4  # fp32 sums taken in another order
W8A8_RTOL = 1e-6  # one product on the same activations (tests/test_torch_rows.py)
FLIP_RTOL = 1e-2  # an activation one int8 step the other way: ~1e-3 of the largest

TINY = {
    "sweep_vision_attention": (sva, ["--patches", str(P), "--heads", str(H), "--head-dim",
                                     str(D), "--wp", str(WP), "--intermediate", str(INTER)]),
    "sweep_vit_fullatt": (sfa, ["--seq", "128"]),
    "i8attn_microbench": (i8m, ["--s-vit", "128", "--s-llm", "128"]),
}
CHECK_KEYS = {"max_abs_err", "rel_err", "rms_rel_err", "ok"}
ATTENTION_KEYS = {"name", "shape", "bound_ms", "bound_by", "error", "ms", "device_ms", "share",
                  "tflops_jax", "launches_per_call"} | CHECK_KEYS
BLOCK_ROWS = {"rms", "K1", "qkv(w8a8) -> reshape -> K1", "swiglu", "residual add",
              "attention half (w8a8)", "mlp half (w8a8)", "block (w8a8)", "block (weight-only)"} | {
    f"{tier} {n}" for tier in ("w8a8", "weight-only") for n in sva.LINEARS}


def jax_tool_function(tool: str, name: str, namespace: dict):
    """The JAX tool's nested function ``name``, compiled from its source
    into ``namespace`` (the tools import jax and run on import or in main,
    so they are read, not imported)."""
    tree = ast.parse((JAX_TOOLS / tool).read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)
    exec(compile(ast.Module(body=[node], type_ignores=[]), tool, "exec"), namespace)
    return namespace[name]


def jax_tool_flops(tool: str, **names) -> float:
    """The value of the JAX tool's first ``flops = ...`` / ``fl = ...``
    expression at the given names."""
    tree = ast.parse((JAX_TOOLS / tool).read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name) and n.targets[0].id in ("flops", "fl"))
    return eval(compile(ast.Expression(node.value), tool, "eval"), {}, names)


def time_fields(row):
    return {k: row[k] for k in ab.TIME_KEYS if k in row}


@pytest.mark.parametrize("tool", sorted(TINY))
def test_tool_main_on_cpu_writes_rows(tool, tmp_path):
    mod, argv = TINY[tool]
    out = tmp_path / f"{tool}.json"
    record = mod.main(argv + ["--device", "cpu", "--iters", "2", "--check-rows", "32",
                              "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(record, default=str))
    assert record["failures"] == [] and record["card"] == "cpu"
    if tool == "sweep_vision_attention":
        secs = record["sections"]
        assert sorted(secs) == ["1", "1b", "2"]
        rows1 = secs["1"]["rows"]
        assert [r["heads_per_block"] for r in rows1] == [1, 2]
        assert all(r["bit_equal_to_shipped"] and r["ok"] for r in rows1)
        assert set(secs["1b"]["rows"]) == BLOCK_ROWS
        for name in BLOCK_ROWS:
            row = secs["1b"]["rows"][name]
            assert {"ms", "device_ms", "share", "bound_ms", "bound_by"} <= set(row)
            if name.startswith(("w8a8", "weight-only")):
                assert {"kernels", "gemm_device_ms", "passes_device_ms"} <= set(row)
        assert set(secs["1b"]["block_checks"]) == {
            "k1_in_q8_block", "k1_in_weight_only_block", "q8_block_not_held",
            "weight_only_block_not_held", "q8_against_weight_only_not_held"}
        assert secs["1b"]["block_checks"]["k1_in_q8_block"]["ok"]
        assert secs["1b"]["block_checks"]["k1_in_weight_only_block"]["ok"]
        assert set(secs["1b"]["sums"]) == {"w8a8", "weight-only"}
        rows = rows1 + list(secs["1b"]["rows"].values()) + secs["2"]["rows"]
        assert [r["name"] for r in secs["2"]["rows"]] == ["flash_attention[dense]"] + [
            f"sdpa[{b}]" for b in ab.SDPA_BACKENDS]
        attention = secs["2"]["rows"]
    elif tool == "sweep_vit_fullatt":
        rows = attention = record["rows"]
        assert [r["name"] for r in rows] == ["flash_attention[segmented]",
                                             "flash_attention[dense]"] + [
            f"sdpa[{b}]" for b in ab.SDPA_BACKENDS]
        assert record["best_sdpa"] is None  # nothing timed on the CPU
    else:
        assert sorted(record["shapes"]) == ["llm", "vit"]
        rows = attention = [r for rs in record["shapes"].values() for r in rs]
        for rs in record["shapes"].values():
            assert [r["name"] for r in rs] == ["bf16", "qk8", "all8", "sdpa"]
            assert {"prep_device_ms", "attention_device_ms", "kernels"} <= set(rs[1])
    for row in attention:
        assert ATTENTION_KEYS <= set(row), row
        assert row["error"] is not None or row["ok"], row
    for row in rows:
        assert time_fields(row) and set(time_fields(row).values()) == {ab.NOT_MEASURED}, row
        if row.get("launches_per_call") is not None:
            assert row["launches_per_call"] == 0  # the plain versions launch nothing


def test_heads_per_block_swap(monkeypatch):
    assert sva.divisors(16) == (1, 2, 4, 8, 16) and sva.divisors(H) == (1, 2)
    shipped = wa.plan_window
    base = shipped(80, 64, 16, True)
    seen = []

    def fake_kernel(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(wa, "kernel_function", lambda *a: fake_kernel)
    monkeypatch.setattr(wa, "current_stream", lambda dev: None)
    out = torch.empty(0)
    for g in sva.divisors(16):
        with sva.heads_per_block(g):
            plan = wa.plan_window(80, 64, 16, True)
            assert plan.heads_per_block == g
            assert (plan.dim_pad, plan.smem_bytes) == (base.dim_pad, base.smem_bytes)
            wa._launch("window_attention_fused_bf16", (0,) * 5, out, 65536, 16, 80, 64, True, 7)
        assert wa.plan_window is shipped
    # the launcher's ints: p, h, d, wp, dim_pad, heads per block, smem, vec
    assert [a[10] for a in seen] == list(sva.divisors(16))
    with pytest.raises(RuntimeError, match="a variant fails"):
        with sva.heads_per_block(8):
            raise RuntimeError("a variant fails")
    assert wa.plan_window is shipped
    assert wa.plan_window(80, 64, 16, True).heads_per_block == base.heads_per_block == 4


def test_quantize_int8_matches_jax_tool_quant():
    """quantize_int8 on the tool's draws against the JAX tool's ``quant``
    (tools/sweep_vision_attention.py:96-100), bit for bit."""
    quant = jax_tool_function("sweep_vision_attention.py", "quant", {
        "np": np, "jax": type("jax", (), {"device_put": staticmethod(lambda a: a)})})
    hid = 1280
    for seed, shape in ((0, (hid, 3 * hid)), (1, (hid, hid))):
        w = sva.tool_weights(*shape, seed)
        # the JAX tool's draw, :104-105
        np.testing.assert_array_equal(
            w, np.asarray(np.random.default_rng(seed).normal(size=shape) / 36.0, np.float32))
        q_j, s_j = quant(np.random.default_rng(seed).normal(size=shape) / 36.0)
        got = quantize_int8(torch.from_numpy(w))
        np.testing.assert_array_equal(got["kernel_q"].numpy(), q_j)
        np.testing.assert_array_equal(got["kernel_scale"].numpy(), s_j)


def tiny_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((P, H * D)).astype(np.float32)
    cos = (rng.standard_normal((P, D)) * 0.1 + 1).astype(np.float32)
    sin = (rng.standard_normal((P, D)) * 0.1).astype(np.float32)
    valid = np.ones((P,), bool)
    return x, cos, sin, valid


def recorded_products(monkeypatch):
    """The port's W8A8 products as they run: (x, kernel_q, kernel_scale, y)."""
    calls, own = [], layers.matmul_w8a8

    def record(x, kernel_q, kernel_scale, dtype):
        y = own(x, kernel_q, kernel_scale, dtype)
        calls.append(tuple(t.numpy().copy() for t in (x, kernel_q, kernel_scale, y)))
        return y

    monkeypatch.setattr(layers, "matmul_w8a8", record)
    return calls


def flips(a, b) -> int:
    """Activations that one row rounding to int8 puts one step apart."""
    qa, _ = jq_quantize_rows(a)
    qb, _ = jq_quantize_rows(b)
    return int((qa != qb).sum())


def jq_quantize_rows(x):
    """JAX matmul_w8a8's row quantization (quantization.py:75-78)."""
    xf = np.asarray(x, np.float32)
    scale = np.maximum(np.abs(xf).max(-1, keepdims=True), 1e-8) / np.float32(127.0)
    return np.clip(np.round(xf / scale), -127, 127).astype(np.int8), scale


def assert_halves_close(got, want, n_flips):
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= (HALF_RTOL if n_flips == 0 else FLIP_RTOL), (rel, n_flips)


def test_block_halves_match_jax(monkeypatch):
    """The attention half-block and the MLP half of section 1b against the
    same composition from the JAX package, in fp32."""
    block = sva.make_block(H * D, H, INTER, torch.device("cpu"), torch.float32, seed=0)
    lin = sva.block_linears(block)
    params = {n: (m.kernel_q.numpy(), m.kernel_scale.numpy(), m.bias.detach().numpy())
              for n, m in lin.items()}
    x, cos, sin, valid = tiny_inputs()
    calls = recorded_products(monkeypatch)
    with torch.inference_mode():
        t = [torch.from_numpy(a) for a in (x, cos, sin, valid)]
        attn_t = sva.attention_half(block, *t, WP).numpy()
        mlp_t = sva.mlp_half(block, t[0]).numpy()
    assert len(calls) == 5
    # every product on the port's own activations, through JAX's matmul_w8a8
    w8a8 = jax.jit(jq.matmul_w8a8, static_argnums=3)
    for xa, kq, ks, y in calls:
        ref = np.asarray(w8a8(xa, kq, ks, jnp.float32))
        assert np.abs(y - ref).max() <= W8A8_RTOL * np.abs(ref).max()

    gamma = jnp.ones((H * D,), jnp.float32)
    rms = jax_tool_function("sweep_vision_attention.py", "rms",
                            {"jnp": jnp, "jax": jax, "gamma": gamma})

    def dense(v, name):
        kq, ks, b = params[name]
        return jq.matmul_w8a8(v, kq, ks, jnp.float32) + b

    # the attention half: the JAX tool's t_attn_half (:132-139) with the biases
    h = rms(jnp.asarray(x))
    qkv = dense(h, "qkv").reshape(P, 3, H, D)
    out = pallas_window_fused(qkv, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(valid), WP,
                              interpret=True)
    proj_in = out.reshape(P, H * D)
    attn_j = np.asarray(jnp.asarray(x) + dense(proj_in, "proj"))
    n_flips = flips(calls[0][0], h) + flips(calls[1][0], proj_in)
    assert_halves_close(attn_t, attn_j, n_flips)
    # the MLP half: x + down(silu(gate(rms x)) * up(rms x))
    hm = rms(jnp.asarray(x))
    act = jax.nn.silu(dense(hm, "gate")) * dense(hm, "up")
    mlp_j = np.asarray(jnp.asarray(x) + dense(act, "down"))
    n_flips = flips(calls[2][0], hm) + flips(calls[3][0], hm) + flips(calls[4][0], act)
    assert_halves_close(mlp_t, mlp_j, n_flips)


@pytest.mark.parametrize("tier", ["prefill", "none"])
def test_halves_compose_to_the_block(tier):
    """attention_half then mlp_half is VisionBlock.forward's window path,
    bit for bit, in the (q8) tier and weight-only."""
    block = sva.in_tier(sva.make_block(H * D, H, INTER, torch.device("cpu"), torch.float32),
                        tier)
    x, cos, sin, valid = (torch.from_numpy(a) for a in tiny_inputs())
    with torch.inference_mode():
        want = block(x, cos, sin, None, valid, WP)
        got = sva.mlp_half(block, sva.attention_half(block, x, cos, sin, valid, WP))
    assert torch.equal(got, want)
    assert block.cfg.act_quant == tier


@pytest.mark.parametrize("b,h,s,d,causal", [(1, 16, 65536, 80, False), (1, 28, 8192, 128, True),
                                             (2, 3, 100, 16, False)])
def test_counts_match_jax_formulas(b, h, s, d, causal):
    """JAX's TF/s counts (i8attn_microbench.py:45, sweep_vit_fullatt.py:44,
    sweep_vision_attention.py:169) and the bound's definition."""
    want = jax_tool_flops("i8attn_microbench.py", S=s, D=d, H=h, B=b, causal=causal)
    assert ab.jax_tflop(b, h, s, d, causal) * 1e12 == pytest.approx(want, rel=1e-12)
    if not causal and b == 1:
        assert want == jax_tool_flops("sweep_vit_fullatt.py", S=s, D=d, H=h)
        assert want == jax_tool_flops("sweep_vision_attention.py", P=s, H=h, D=d)
    pairs = ab.attention_pairs(s, causal)
    assert pairs == (s * (s + 1) // 2 if causal else s * s)
    flops, nbytes = 4.0 * pairs * h * d * b, 4 * 2 * b * h * s * d
    ms, by = ab.bound(flops, nbytes)
    assert ms == pytest.approx(max(flops / 989e12, nbytes / 3.35e12) * 1e3)
    assert by == ("operations" if flops / 989e12 >= nbytes / 3.35e12 else "bytes")
    ms8, _ = ab.bound(flops / 2, nbytes, flops / 2)
    assert ms8 == pytest.approx(max(flops / 2 / 989e12 + flops / 2 / 1979e12,
                                    nbytes / 3.35e12) * 1e3)


def test_tool_bounds_count_the_shapes(tmp_path):
    """The rows' bounds at a tiny shape: K2 and SDPA over every pair, q, k,
    v and out (fp32 on the CPU) and the segment ids once each."""
    s, h, d = 128, 16, 80
    record = sfa.main(["--device", "cpu", "--seq", str(s), "--check-rows", "8",
                       "--out", str(tmp_path / "f.json")])
    io = 4 * 4 * h * s * d
    for row in record["rows"]:
        extra = 2 * 4 * s if row["name"] == "flash_attention[segmented]" else 0
        assert row["bound_ms"] == pytest.approx(
            max(4.0 * s * s * h * d / 989e12, (io + extra) / 3.35e12) * 1e3), row


def test_tools_draw_jax_inputs():
    """q, k, v as the JAX tools draw them (sweep_vit_fullatt.py:28-33,
    i8attn_microbench.py:27-30), bf16 bit for bit."""
    q, k, v = ab.numpy_qkv(1, 2, 64, 16, torch.device("cpu"), torch.bfloat16)
    rng = np.random.default_rng(0)
    for got in (q, k, v):
        want = jnp.asarray(rng.standard_normal((1, 2, 64, 16)), jnp.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))

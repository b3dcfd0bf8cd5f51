"""The port's bench protocols (glimpseprune_torch/tools/bench_protocols.py,
serving_frontier.py, sweep_reduce_layer.py) against the JAX bench on the
CPU at the tiny config: the config each BENCH_* environment gives, the
aggregated protocol's tokens and first logits against the JAX assembly that
bench.run_serving performs on shared weights, the continuous side's tokens
against the aggregated ones, the OOM ladder's rungs, the JSON lines'
metric names and keys as bench.py writes them, and the two tools."""

import ast
import contextlib
import dataclasses
import functools
import io
import json
import os
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (the JAX bench; imports no jax at module level)
import serving_frontier as jax_frontier  # noqa: E402  (the JAX tool)
from test_torch_inputs import make_setup  # noqa: E402

from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner  # noqa: E402
from glimpseprune_tpu.ops import kv_cache as jax_kv  # noqa: E402

from glimpseprune_torch.tools import bench_protocols as bp  # noqa: E402

TINY = ["--device", "cpu", "--scale", "tiny", "--max-pixels", "12544"]
ROWS_P, ROWS_U, N_DEC = 3, 2, 4
PEAK_KEYS = {"pruned_peak_gib", "unpruned_peak_gib"}
BENCH_VARS = ("BENCH_MODE", "BENCH_SCALE", "BENCH_QUANT", "BENCH_ACT_QUANT", "BENCH_QK_INT8",
              "BENCH_PV_INT8", "BENCH_KV_QUANT", "BENCH_MAX_PIXELS", "BENCH_SERVE_CHUNK",
              "BENCH_SERVE_ROWS_P", "BENCH_SERVE_ROWS_U", "BENCH_DECODE",
              "BENCH_SERVE_INTER_STEPS", "BENCH_REDUCE_LAYER", "BENCH_USE_REF", "BENCH_BATCH",
              "BENCH_TRAIN_ROW")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny model's small products run faster on one thread here."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_env(monkeypatch):
    for k in BENCH_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def tiny_args(*extra):
    with mock.patch.dict(os.environ, {k: v for k, v in os.environ.items()
                                      if k not in BENCH_VARS}, clear=True):
        return bp.parse_args(TINY + ["--serve-rows-p", str(ROWS_P), "--serve-rows-u",
                                     str(ROWS_U), "--decode", str(N_DEC), *extra])


@functools.lru_cache(maxsize=None)
def setup_pair():
    """The JAX tiny config in the bench's default KV tier (int8), its
    params, the JAX prep of the bench's request, and the port's setup on a
    model holding the same weights."""
    from glimpseprune_torch.convert import load_from_jax

    s = make_setup()
    cfg_j = dataclasses.replace(s.cfg, text=dataclasses.replace(s.cfg.text,
                                                                kv_cache_quant="int8"))
    args = tiny_args()
    cfg_t = bp.bench_cfg(args)
    model = load_from_jax(s.params, cfg_t, device="cpu")
    st = bp.setup(args, model)
    rng = np.random.default_rng(0)  # bench.py:468-476, folded into the tiny vocabulary
    side = int((args.max_pixels * 1.3) ** 0.5)
    img = rng.integers(0, 255, (side, side, 3), dtype=np.uint8)
    prompt = bp.prompt_ids(cfg_t, rng)
    prep_j = jax_runner.prepare_inputs(cfg_j, [prompt], [img], max_pixels=args.max_pixels)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    np.testing.assert_array_equal(prep_j.input_ids, st.prep.input_ids)
    np.testing.assert_array_equal(prep_j.patches, st.prep.patches)
    return dict(cfg_j=cfg_j, params=s.params, args=args, cfg_t=cfg_t, st=st, prep_j=prep_j)


@functools.lru_cache(maxsize=None)
def serving_run():
    p = setup_pair()
    return bp.run_serving(p["args"], s=p["st"])


def jax_serving(p):
    """bench.run_serving's assembly (bench.py:563-628, without the input
    perturbation) on the JAX runner: B = 1 prefills filled into one
    preallocated cache per side, one prealloc_t decode. -> {side: (seqs,
    first logits [rows, V])}."""
    cfg, params, prep = p["cfg_j"], p["params"], p["prep_j"]
    jr = jax_runner.GlimpsePruneRunner(cfg, params)
    di = jr._device_inputs(prep, use_ref_masks=False)
    le = cfg.gp.le_length
    L, hkv, d = (cfg.text.num_hidden_layers, cfg.text.num_key_value_heads,
                 cfg.text.head_dim)
    out = {}
    for side, rows in (("pruned", ROWS_P), ("unpruned", ROWS_U)):
        if side == "pruned":
            o = jr.glimpse(prep)
            logits, valid, pos, kk, vv = o.logits, o.valid, o.position_ids, o.kv_k, o.kv_v
        else:
            merged = jr._vision({"params": params}, di["patches"], di["vis_pos_ids"],
                                di["full_seg"], di["vis_valid"],
                                dense_attn=jax_runner._vis_dense_hint(prep))[0]
            valid, pos = di["valid"][:, :-le], di["position_ids"][:, :, :-le]
            logits, kk, vv = jr.model.apply(
                {"params": params}, di["input_ids"][:, :-le], valid, pos, merged,
                di["packed_idx"], di["img_slots"], di["img_valid"], True,
                method=jr.model.vanilla_prefill)
        t = valid.shape[1] + N_DEC
        kc, vc = (jax_kv.alloc_cache((L, rows, t, hkv, d), jnp.float32, "int8")
                  for _ in range(2))
        for i in range(rows):  # every chunk is the same request
            kc = jax_kv.cache_fill_rows(kc, kk, jnp.int32(i))
            vc = jax_kv.cache_fill_rows(vc, vv, jnp.int32(i))
        cat = lambda x, ax: jnp.concatenate([x] * rows, axis=ax)  # noqa: E731
        seqs, _ = jr._decode_loop(cat(logits, 0), cat(valid, 0), cat(pos, 1), kc, vc, N_DEC,
                                  -1, chunk_size=N_DEC, prealloc_t=t)
        out[side] = (np.asarray(seqs), np.asarray(cat(logits, 0)[:, -1]))
    return out


# ---- (a) the config from the environment

ENV_GRID = [
    {},  # main's defaults: int8 at 7b, W8A8 prefill, int8 KV
    {"BENCH_QUANT": "int8", "BENCH_ACT_QUANT": "none"},
    {"BENCH_QUANT": "int8", "BENCH_ACT_QUANT": "int8", "BENCH_QK_INT8": "vit"},
    {"BENCH_QUANT": "int8", "BENCH_ACT_QUANT": "prefill", "BENCH_PV_INT8": "text"},
    {"BENCH_QUANT": "int4", "BENCH_ACT_QUANT": "prefill", "BENCH_QK_INT8": "1",
     "BENCH_PV_INT8": "vision"},
    {"BENCH_QUANT": "int4", "BENCH_KV_QUANT": "none"},
    {"BENCH_QUANT": "int8", "BENCH_ACT_QUANT": "prefill", "BENCH_PV_INT8": "both",
     "BENCH_KV_QUANT": "none"},
    {"BENCH_SCALE": "3b"},
    {"BENCH_SCALE": "1b", "BENCH_QUANT": "int8"},
]


def jax_bench_cfg(env):
    """bench.main's defaults (:870-878), then _quant_from_env(build_cfg);
    env: the monkeypatch that sets the variables."""
    scale = os.environ.get("BENCH_SCALE", "7b")
    if scale == "7b" and not os.environ.get("BENCH_QUANT"):
        env.setenv("BENCH_QUANT", "int8")
    if os.environ.get("BENCH_QUANT") == "int8" and "BENCH_ACT_QUANT" not in os.environ:
        env.setenv("BENCH_ACT_QUANT", "prefill")
    return bench._quant_from_env(bench.build_cfg(scale))


@pytest.mark.parametrize("env", ENV_GRID, ids=lambda e: ",".join(
    f"{k[6:]}={v}" for k, v in e.items()) or "defaults")
def test_config_from_env_equals_jax(env, clean_env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    args = bp.parse_args([])
    got = bp.bench_cfg(args)
    want, quant = jax_bench_cfg(clean_env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert args.quant == quant
    sfx = ("_" + os.environ.get("BENCH_SCALE", "7b") + (f"_{quant}" if quant else "")
           + ("_w8a8" if want.text.act_quant != "none" else ""))
    assert bp.suffix(args, got) == sfx
    if not env:  # the default tier is tools/common's (q8) tier
        from glimpseprune_torch.tools.common import bench_config, tier_config

        assert dataclasses.asdict(got) == dataclasses.asdict(
            tier_config(bench_config("7b"), "int8"))
        assert (args.mode, args.serve_rows_p, args.serve_rows_u, args.decode,
                args.max_pixels, args.serve_inter_steps) == ("serving", 48, 7, 1024,
                                                             12845056, 8)


def test_flag_defaults_follow_the_mode(clean_env):
    assert bp.parse_args(["--mode", "e2e"]).decode == 128
    assert bp.parse_args(["--mode", "continuous"]).serve_rows_p == 8
    clean_env.setenv("BENCH_MODE", "continuous")
    clean_env.setenv("BENCH_DECODE", "16")
    args = bp.parse_args([])
    assert (args.mode, args.decode, args.serve_rows_p) == ("continuous", 16, 8)
    clean_env.setenv("BENCH_QK_INT8", "bogus")
    with pytest.raises(ValueError, match="BENCH_QK_INT8"):
        bp.parse_args([])


# ---- (b) the aggregated protocol against JAX

def test_serving_matches_jax_assembly():
    p = setup_pair()
    run = serving_run()
    want = jax_serving(p)
    for side, rows in (("pruned", ROWS_P), ("unpruned", ROWS_U)):
        seqs, first = want[side]
        np.testing.assert_array_equal(run.tokens[side], seqs, err_msg=side)
        got = run.first_logits[side].numpy()
        assert np.abs(got - first).max() <= 1e-4 * np.abs(first).max(), side
        assert run.sides[side]["n"] == rows * N_DEC
    det = run.result["detail"]
    assert (det["pruned_batch"], det["unpruned_batch"], det["n_decode"]) == (ROWS_P, ROWS_U,
                                                                            N_DEC)
    assert run.result["value"] == round(ROWS_P * N_DEC / run.sides["pruned"]["wall_s"], 1)


# ---- (c) the continuous side

@pytest.mark.parametrize("side", ["pruned", "unpruned"])
def test_continuous_side_gives_the_aggregated_tokens(side):
    p = setup_pair()
    rec, seqs = bp.run_continuous_side(p["args"], side, s=p["st"])
    agg = serving_run().tokens[side]
    np.testing.assert_array_equal(seqs, agg)
    assert (rec["B"], rec["n_gen"], rec["n_decode"]) == (len(agg), agg.size, N_DEC)
    assert len(rec["ttft_s"]) == len(agg) and rec["R"] == p["st"].runner.prefill(
        p["st"].prep, do_selection=side == "pruned").valid.shape[1]


# ---- (d) the ladder

def in_process_rung(fail, tried):
    """child_rung's stand-in: the side's process body run here (its model
    the shared one), a planted error at the B's ``fail`` names."""
    p = setup_pair()
    run_side = bp.run_continuous_side

    def rung(args, side, b, log=None, timeout=None):
        tried.append((side, b))
        cargs = bp.parse_args(bp.child_argv(args, side, b))
        out, code = io.StringIO(), 0

        def planted(a, sd, model=None, s=None):
            err = fail(sd, b)
            if err is not None:
                raise err
            return run_side(a, sd, s=p["st"])

        with contextlib.redirect_stdout(out), mock.patch.object(
                bp, "run_continuous_side", planted):
            try:
                bp.run_side_child(cargs)
            except SystemExit as e:
                code = e.code
            except Exception as e:  # a child's traceback and exit code 1
                out.write(f"Traceback: {e!r}\n")
                code = 1
        return bp.rung_outcome(code, out.getvalue(), side, b)

    return rung


def oom_above_2(side, b):
    import torch

    return torch.cuda.OutOfMemoryError(f"CUDA out of memory (planted at B={b})") if b > 2 \
        else None


@functools.lru_cache(maxsize=None)
def continuous_run():
    tried = []
    with mock.patch.object(bp, "child_rung", in_process_rung(oom_above_2, tried)), \
            contextlib.redirect_stdout(io.StringIO()):
        run = bp.main(TINY + ["--mode", "continuous", "--serve-rows-p", "5", "--serve-rows-u",
                              "7", "--decode", str(N_DEC)])
    return run, tried


def test_ladder_steps_down_jax_rungs():
    run, tried = continuous_run()
    # JAX's rungs: dedup([5, 5 // 2, 4]) and dedup([7, 7 - 2, 7 // 2, 3, 2]) (bench.py:933, :949)
    assert tried == [("pruned", 5), ("pruned", 2), ("unpruned", 7), ("unpruned", 5),
                     ("unpruned", 3), ("unpruned", 2)]
    det = run.result["detail"]
    assert (det["pruned_batch"], det["unpruned_batch"], det["unpruned_reused"]) == (2, 2, False)
    assert run.sides["pruned"]["rungs"] == [{"B": 5, "outcome": "oom"},
                                            {"B": 2, "outcome": "served"}]
    assert [r["outcome"] for r in run.sides["unpruned"]["rungs"]] == ["oom"] * 3 + ["served"]
    assert run.result["vs_baseline"] == round(det["pruned_tok_s"] / det["unpruned_tok_s"], 3)


def test_ladder_raises_on_other_errors():
    tried = []
    rung = in_process_rung(lambda side, b: ValueError("planted, not a memory error"), tried)
    with mock.patch.object(bp, "child_rung", rung), pytest.raises(RuntimeError,
                                                                  match="not out of memory"):
        bp.main(TINY + ["--mode", "continuous", "--serve-rows-p", "5", "--decode", "2"])
    assert tried == [("pruned", 5)]


def test_ladder_runs_a_side_in_its_own_process(monkeypatch):
    """One real rung: the side's process parses the flags it is given and
    answers with its record."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    args = tiny_args("--mode", "continuous")
    outcome, rec = bp.child_rung(args, "pruned", 2)
    assert outcome == "served" and rec["B"] == 2 and rec["n_gen"] == 2 * N_DEC


# ---- (e) metric names and detail keys

def jax_lines():
    """{metric prefix: detail keys} of bench.py's four JSON lines, read from
    its source: the dicts with a "metric" key, their "detail" dicts (inline,
    or run()'s ``detail`` with ``decode_detail`` merged into the e2e line)."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())

    def keys(d):
        return {k.value for k in d.keys if isinstance(k, ast.Constant)}

    assigned = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and isinstance(node.targets[0], ast.Name) and node.value.keys):
            assigned[node.targets[0].id] = keys(node.value)
    out = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Dict) and "metric" in keys(node)):
            continue
        kv = {k.value: v for k, v in zip(node.keys, node.values) if isinstance(k, ast.Constant)}
        prefix = kv["metric"].values[0].value
        det = kv["detail"]
        dk = keys(det) if isinstance(det, ast.Dict) else set(assigned[det.id])
        if prefix.startswith("gp_e2e"):
            dk |= assigned["decode_detail"]
        out[prefix] = dk
    return out


@functools.lru_cache(maxsize=None)
def e2e_runs():
    p = setup_pair()
    runs = {}
    for n_dec in (2, 0):
        args = tiny_args("--mode", "e2e", "--decode", str(n_dec), "--iters", "1",
                         "--decode-iters", "1")
        runs[n_dec] = bp.run_e2e(args, model=p["st"].model)
    return runs


@pytest.mark.parametrize("line", ["serving", "continuous", "e2e", "prefill"])
def test_json_lines_have_bench_names_and_keys(line):
    want = jax_lines()
    run = {"serving": serving_run, "continuous": lambda: continuous_run()[0],
           "e2e": lambda: e2e_runs()[2], "prefill": lambda: e2e_runs()[0]}[line]()
    res = run.result
    prefix = next(p for p in want if res["metric"] == p + "_tiny")
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert set(res["detail"]) == want[prefix] | PEAK_KEYS
    assert res["unit"] == "tokens/s" and np.isfinite(res["value"]) and res["value"] > 0
    assert len(want) == 4


# ---- (f) the tools

@pytest.mark.parametrize("argv", [["--points", "48:int8:int8,8:fp:int4"],
                                  ["--batches", "8,16", "--kv", "int8", "--weights", "int8,int4"],
                                  []])
def test_serving_frontier_dry_lists_jax_points(argv, monkeypatch, capsys):
    from glimpseprune_torch.tools import serving_frontier

    monkeypatch.setattr(sys, "argv", ["serving_frontier.py", *argv, "--dry"])
    jax_frontier.main()
    want = capsys.readouterr().out
    serving_frontier.main([*argv, "--dry"])
    assert capsys.readouterr().out == want


def jax_row_keys(path, func):
    """The keys of the last dict literal returned (or assigned to ``row``)
    in ``func`` of a JAX tool."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", path)).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    dicts = sorted((n for n in ast.walk(fn)
                    if isinstance(n, (ast.Return, ast.Assign)) and isinstance(n.value, ast.Dict)
                    and (isinstance(n, ast.Return) or n.targets[0].id == "row")),
                   key=lambda n: n.lineno)
    return {k.value for k in dicts[-1].value.keys}


def test_serving_frontier_rows(tmp_path):
    """Two points of one tier: JAX's row keys, the second point's unpruned
    side reused from the first, B_actual the rung served."""
    from glimpseprune_torch.tools import serving_frontier

    tried = []
    out = tmp_path / "frontier.json"
    with mock.patch.object(bp, "child_rung", in_process_rung(oom_above_2, tried)):
        res = serving_frontier.main(["--points", "2:int8:,4:int8:", "--decode", str(N_DEC),
                                     "--rows-u", "2", "--out", str(out), "--", *TINY])
    rows = json.loads(out.read_text())["rows"]
    assert res["rows"] == rows and len(rows) == 2
    assert all(set(r) == jax_row_keys("serving_frontier.py", "run_point") for r in rows)
    by_b = {r["B"]: r for r in rows}
    assert (by_b[2]["B_actual"], by_b[4]["B_actual"]) == (2, 2)
    assert (by_b[2]["unpruned_reused"], by_b[4]["unpruned_reused"]) == (False, True)
    assert tried == [("pruned", 2), ("unpruned", 2), ("pruned", 4), ("pruned", 2)]
    assert (tmp_path / "frontier.json.logs" / "B4_int8_.log").exists()


def test_sweep_reduce_layer_rows(tmp_path, clean_env):
    from glimpseprune_torch.tools import sweep_reduce_layer

    out = tmp_path / "sweep.json"
    res = sweep_reduce_layer.main(["--layers", "1,2", "--scale", "tiny", "--decode", "2",
                                   "--out", str(out), "--", "--device", "cpu",
                                   "--max-pixels", "12544", "--iters", "1",
                                   "--decode-iters", "1"])
    written = json.loads(out.read_text())
    assert written == res
    assert set(written) == {"scale", "quant", "act_quant", "decode", "rows"}
    assert (written["quant"], written["act_quant"]) == ("int8", "none")
    assert [r["reduce_layer"] for r in written["rows"]] == [1, 2]
    want = jax_row_keys("sweep_reduce_layer.py", "main")
    assert all(set(r) == want for r in written["rows"])
    assert all(np.isfinite(r["prefill_ratio"]) for r in written["rows"])


@pytest.mark.parametrize("outcome", ["ok", "failed", "timeout"])
def test_serving_train_row(outcome, clean_env, monkeypatch, tmp_path):
    """At 7b int8 the serving mode runs the 16k train step row first, in
    its own process (profile_train_step on the bench's 7B config); a row
    that fails or times out is written into detail as an error."""
    import subprocess

    calls = []

    def fake_run(cmd, **kw):
        calls.append((cmd, kw))
        if outcome == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        out = json.dumps({"train_step_s": 4.5}) if outcome == "ok" else "Traceback ..."
        return subprocess.CompletedProcess(cmd, 0 if outcome == "ok" else 1, out)

    monkeypatch.setattr(bp, "ROOT", tmp_path)
    monkeypatch.setattr(bp.subprocess, "run", fake_run)
    monkeypatch.setattr(bp, "run_serving", lambda args: bp.BenchRun(
        {"metric": "m", "value": 1.0, "unit": "tokens/s", "vs_baseline": 1.0, "detail": {}},
        {}, {}))
    with contextlib.redirect_stdout(io.StringIO()):
        run = bp.main(["--device", "cpu"])
    (cmd, kw), = calls
    assert cmd[1:3] == ["-m", "glimpseprune_torch.tools.profile_train_step"]
    assert cmd[cmd.index("--img-side") + 1] == "3584" and kw["timeout"] == 900
    cfg_dir = cmd[cmd.index("--model-config") + 1]
    from glimpseprune_torch.config import ModelConfig
    from glimpseprune_torch.tools.common import bench_config

    assert ModelConfig.load(cfg_dir) == bench_config("7b")
    row = run.result["detail"][bp.TRAIN_ROW_KEY]
    assert row == {"train_step_s": 4.5} if outcome == "ok" else "error" in row

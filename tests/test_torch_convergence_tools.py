"""The port's synthetic-boxes training tools against the JAX package's
(tools/convergence_run.py, sweep_reduce_quality.py, demo.py --int8,
judge_loadtest.py) on the CPU: the corpora (rows and JPEG bytes), the
char tokenizer, the bench configs, the base stage's history on the JAX
tool's tiny weights (3 steps, the bound of test_trainer_history_matches_jax)
and its resume, the GRPO stage's interleaved base step and adapter-free
probe, the sweep's rows (the latency sweep it reads left as it was), demo
--int8's tokens against the JAX runner on ``quantize_int8`` weights, and
the judge load test against a local stub judge."""

import contextlib
import dataclasses
import functools
import hashlib
import http.server
import io
import json
import os
import socketserver
import sys
import threading

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)

import convergence_run as jax_conv  # noqa: E402  (the JAX tool)
from tools.demo import make_tiny  # noqa: E402  (the JAX tool's tiny model)

HISTORY_KEYS = ("loss", "loc_loss", "le_loss", "mask_iou")
# the keys of the JAX tool's grpo_log.json rows (tools/convergence_run.py:233-254,
# glimpseprune_tpu/training/grpo.py:199-204, :388)
JAX_GRPO_KEYS = {"elapsed_s", "grpo_total", "kd_loss", "le_loss", "loc_loss", "loss",
                 "mask_iou", "mean_advantage", "mean_score", "probe_acc_frozen",
                 "probe_acc_policy", "probe_completions", "reward_loss", "step"}


@functools.lru_cache(maxsize=None)
def jax_tiny():
    """The JAX tool's tiny model (tools/demo.py make_tiny): config, params,
    tokenizer."""
    return make_tiny()


def port_tiny_model():
    """A fresh port model holding the JAX tiny params (fp32, CPU)."""
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import load_from_jax

    cfg = tiny_test_config()
    return cfg, load_from_jax(jax_tiny()[1], cfg, device="cpu")


def tree_digest(root):
    """{relative path: sha256} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.mark.parametrize("kind", ["synth", "grpo_lr", "grpo_const"])
def test_corpora_equal_jax(kind, tmp_path):
    """The same rows (config, jsonl) and byte-equal JPEG files."""
    from glimpseprune_torch.tools import convergence_run as port

    outs = []
    for name, mod in (("jax", jax_conv), ("port", port)):
        root = str(tmp_path / name)
        if kind == "synth":
            cfg, img_dir = mod.make_synth_corpus(root, 5, 84)
        else:
            cfg, img_dir = mod.make_grpo_corpus(root, 5, 96, answers=kind[5:])
        with open(cfg["datasets"][0]["json_path"]) as f:
            rows = f.read()
        cfg["datasets"][0]["json_path"] = os.path.relpath(cfg["datasets"][0]["json_path"],
                                                          root)
        outs.append((cfg, os.path.relpath(img_dir, root), rows, tree_digest(img_dir)))
    assert outs[0] == outs[1]
    assert len(outs[1][3]) == 5


def test_char_tokenizer_equals_jax():
    """A round trip, the 48-char cut, non-ASCII dropped, and detok's guard
    at its edges (ids 4, 5, 132, 133)."""
    from glimpseprune_torch.tools.convergence_run import char_tokenizer

    (tok, detok), (jtok, jdetok) = char_tokenizer(), jax_conv.char_tokenizer()
    for text in ["which half?", "l", "x" * 60, "café r", ""]:
        assert tok(text) == jtok(text)
    assert detok(tok("which half?")) == "which half?"
    ids = [0, 4, 5, 6, 131, 132, 133, 134, 500]
    assert detok(ids) == jdetok(ids) == "??\x00\x01~\x7f??" "?"


@pytest.mark.parametrize("scale,override", [("1b", None), ("3b", None), ("7b", None),
                                            ("7b", 10), ("3b", 30)])
def test_bench_config_equals_build_cfg(scale, override):
    from bench import build_cfg

    from glimpseprune_torch.tools.common import bench_config

    assert dataclasses.asdict(bench_config(scale, override)) == dataclasses.asdict(
        build_cfg(scale, override))


def port_args(tmp_path, out, *extra):
    from glimpseprune_torch.tools.convergence_run import build_parser

    return build_parser().parse_args(
        ["--scale", "tiny", "--img-side", "84", "--n-samples", "6", "--out",
         str(tmp_path / out), "--data-root", str(tmp_path / "data"), "--save-every", "0",
         "--log-every", "1", "--device", "cpu", *extra])


def test_base_stage_history_matches_jax_tool(tmp_path, monkeypatch):
    """3 steps of the base stage on the JAX tool's tiny weights give the JAX
    tool's history (its trainer made to log every step) at rtol 1e-4."""
    import glimpseprune_tpu.training.trainer as jax_trainer
    import tools.demo

    from glimpseprune_torch.tools.convergence_run import run_base

    class EveryStep(jax_trainer.TrainerConfig):
        def __init__(self, **kw):
            super().__init__(**{**kw, "log_every": 1})

    monkeypatch.setattr(jax_trainer, "TrainerConfig", EveryStep)
    monkeypatch.setattr(tools.demo, "make_tiny", jax_tiny)
    monkeypatch.setattr(sys, "argv", ["convergence_run", "--scale", "tiny", "--img-side", "84",
                                      "--n-samples", "6", "--steps", "3", "--save-every", "0",
                                      "--out", str(tmp_path / "jax"), "--data-root",
                                      str(tmp_path / "jdata")])
    with contextlib.redirect_stdout(io.StringIO()):
        jax_conv.main()
    with open(tmp_path / "jax" / "train_log.json") as f:
        want = json.load(f)
    cfg, model = port_tiny_model()
    got = run_base(port_args(tmp_path, "port", "--steps", "3"), cfg, model).history
    assert [h["step"] for h in got] == [h["step"] for h in want] == [1, 2, 3]
    for g, w in zip(got, want):
        for key in HISTORY_KEYS:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {g['step']} {key}")


def test_base_stage_resume_equals_uninterrupted(tmp_path):
    """3 steps, then a run resumed from their checkpoint to step 5: it
    starts at step 4, carries the first rows over, and steps 4 and 5 equal
    an uninterrupted 5-step run's; the frozen base is unchanged."""
    from glimpseprune_torch.tools.convergence_run import run_base

    part = run_base(port_args(tmp_path, "part", "--steps", "3"), *port_tiny_model())
    resumed = run_base(port_args(tmp_path, "resumed", "--steps", "5", "--resume-from",
                                 str(tmp_path / "part")), *port_tiny_model())
    full = run_base(port_args(tmp_path, "full", "--steps", "5"), *port_tiny_model())
    assert resumed.summary["start_step"] == 3 and resumed.summary["steps_run"] == 2
    assert [h["step"] for h in resumed.history] == [h["step"] for h in full.history] == [
        1, 2, 3, 4, 5]
    assert resumed.history[:3] == part.history
    for h, w in zip(resumed.history[3:], full.history[3:]):
        for key in HISTORY_KEYS:
            np.testing.assert_allclose(h[key], w[key], rtol=1e-6, err_msg=f"{h['step']} {key}")
    s = full.summary
    assert s["base_checksum_before"] == s["base_checksum_after"]
    assert 0 < s["host_share"] < 1


def char_parity(queries, answers, completions, **kw):
    """A reward that varies across a random policy's samples (the first
    char's code point mod 2), so that the advantages are not all zero."""
    return [float(ord(c[0]) % 2) if c else 0.0 for c in completions]


def test_grpo_stage_base_step_probe_and_log(tmp_path, monkeypatch):
    """Two GRPO-stage steps: the log has the JAX tool's keys (grpo_log.json
    too); each interleaved base step's losses are those of a GPTrainer step
    on the same weights without adapters; the adapters' B moved, the frozen
    base did not; the probe's adapter-free arm gives the greedy tokens of
    the model with its adapters removed."""
    from glimpseprune_torch.training.grpo import SCORE_FUNCS
    from glimpseprune_torch.evalsuite.data import load_image
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.tools.common import base_checksum
    from glimpseprune_torch.tools.convergence_run import (
        char_tokenizer,
        make_grpo_corpus,
        probe_tokens,
        run_grpo,
    )
    from glimpseprune_torch.training.data import GPDataset
    from glimpseprune_torch.training.lora import lora_tree, make_lora_params, remove_lora
    from glimpseprune_torch.training.trainer import GPTrainer, TrainerConfig, step_generator

    args = port_args(tmp_path, "grpo", "--grpo", "--steps", "2", "--grpo-probe-every", "1",
                     "--grpo-g", "4", "--grpo-new-tokens", "3", "--grpo-score", "char_parity")
    monkeypatch.setitem(SCORE_FUNCS._items, "char_parity", char_parity)
    cfg, model = port_tiny_model()
    checksum = base_checksum(model)
    run = run_grpo(args, cfg, model)
    assert [set(h) for h in run.history] == [JAX_GRPO_KEYS] * 2
    with open(tmp_path / "grpo" / "grpo_log.json") as f:
        assert json.load(f) == json.loads(json.dumps(run.history))
    assert all(np.isfinite(h[k]) for h in run.history
               for k in ("mean_score", "reward_loss", "kd_loss", "loss"))

    # the base steps, replayed on a model that never had adapters
    tok, detok = char_tokenizer()
    config, img_dir = make_grpo_corpus(str(tmp_path / "data"), 6, 96)
    dataset = GPDataset(config, img_dir=img_dir, tokenize=tok)
    tcfg = TrainerConfig(learning_rate=args.lr, batch_size=1, num_epochs=1, log_every=10,
                         save_every=0, output_dir=str(tmp_path / "witness"),
                         seq_multiple=8, patch_multiple=16)
    witness = GPTrainer(cfg, port_tiny_model()[1], dataset, tok, load_image=load_image,
                        tcfg=tcfg)
    order = list(np.random.default_rng(0).permutation(len(dataset)))
    for step, h in enumerate(run.history, start=1):
        batch = witness.collate(witness.cfg, [dataset[order.pop()]], tok, load_image, tcfg,
                                device="cpu")
        m = witness.step_fn(batch, step_generator(1, 2 * step, "cpu"))
        for key in HISTORY_KEYS:
            np.testing.assert_allclose(h[key], float(m[key]), rtol=1e-6,
                                       err_msg=f"step {step} {key}")

    start = make_lora_params(run.model, rank=args.grpo_rank, seed=0)
    now = lora_tree(run.model)
    assert any(not np.array_equal(now[k]["b"].numpy(), start[k]["b"].numpy()) for k in start)
    assert base_checksum(run.model) == checksum == run.summary["base_checksum_after"]

    samples = [dataset[i] for i in range(len(dataset))]
    prep = prepare_inputs(cfg, [[cfg.vision_start_token_id, cfg.image_token_id,
                                 cfg.vision_end_token_id] + tok(s.query) for s in samples],
                          [load_image(s.img_path) for s in samples], seq_multiple=8,
                          patch_multiple=16)
    seqs, n_gen = probe_tokens(GlimpsePruneRunner(run.cfg, run.model), prep, 3, False)
    bare = remove_lora(run.model)
    want = GlimpsePruneRunner(cfg, bare).generate(prep, max_new_tokens=3)
    np.testing.assert_array_equal(seqs, want.sequences)
    np.testing.assert_array_equal(n_gen, want.num_generated)


def test_tiny8_config_equals_jax():
    import sweep_reduce_quality as jax_sweep

    from glimpseprune_torch.tools.sweep_reduce_quality import tiny8_config, tiny8_layer

    for rl in range(1, 8):
        assert dataclasses.asdict(tiny8_config(rl)) == dataclasses.asdict(
            jax_sweep.tiny8_config(rl))
    assert [tiny8_layer(rl) for rl in (2, 6, 10, 14, 18)] == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("source", ["layers", "sweep_file"])
def test_sweep_writes_jax_rows_and_leaves_the_sweep(source, tmp_path):
    """--layers 2,18 or the latency sweep's own rows, 2 steps each: the
    output holds the JAX tool's row keys and note, and the sweep file it
    read is byte-unchanged."""
    from glimpseprune_torch.tools import sweep_reduce_quality

    sweep_path = os.path.join(ROOT, "docs", "sweep_reduce_layer.json")
    with open(sweep_path, "rb") as f:
        before = f.read()
    jax_rows = json.loads(before)["rows"]
    argv = ["--steps", "2", "--n-samples", "6", "--data-root", str(tmp_path / "data"),
            "--device", "cpu"]
    argv += ["--layers", "2,18"] if source == "layers" else ["--sweep", sweep_path]
    with contextlib.redirect_stdout(io.StringIO()):
        sweep_reduce_quality.main(argv)
    with open(sweep_path, "rb") as f:
        assert f.read() == before
    with open(tmp_path / "data" / "sweep_reduce_layer.json") as f:
        got = json.load(f)
    proxy = {"tiny8_layer", "iou_tiny8_proxy", "final_loss", "first_loss"}
    if source == "layers":
        assert [r["reduce_layer"] for r in got["rows"]] == [2, 18]
        assert [set(r) for r in got["rows"]] == [{"reduce_layer"} | proxy] * 2
    else:
        assert [set(r) for r in got["rows"]] == [set(r) for r in jax_rows]
        assert {k: v for k, v in got.items() if k not in ("rows", "iou_proxy_note")} == {
            k: v for k, v in json.loads(before).items() if k not in ("rows", "iou_proxy_note")}
    assert [r["tiny8_layer"] for r in got["rows"]][-1] == 5
    assert all(np.isfinite(r["iou_tiny8_proxy"]) for r in got["rows"])
    assert got["iou_proxy_note"] == json.loads(before)["iou_proxy_note"].replace(
        "300 steps", "2 steps")


def test_demo_int8_matches_jax_runner(tmp_path):
    """demo --int8 on a tiny full-params checkpoint: weight-only int8 tokens
    equal to the JAX runner's on ``quantize_int8`` of the same params."""
    from glimpseprune_tpu import quantization as jq
    from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
    from glimpseprune_tpu.ops import attention as jax_attention

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.models.layers import QuantLinear
    from glimpseprune_torch.persistence import save_full_params
    from glimpseprune_torch.tools import demo
    from glimpseprune_torch.tools.common import StandInTokenizer
    from test_torch_inputs import make_setup

    s = make_setup()
    cfg = tiny_test_config()
    save_full_params(load_from_jax(s.params, cfg, device="cpu"), cfg, str(tmp_path / "full"))
    image = np.random.default_rng(3).integers(0, 256, (56, 84, 3), dtype=np.uint8)
    np.save(tmp_path / "img.npy", image)
    question = "what is in the picture"
    with contextlib.redirect_stdout(io.StringIO()):
        got = demo.main(["--image", str(tmp_path / "img.npy"), "--question", question,
                         "--max-new-tokens", "6", "--int8", "--full-params",
                         str(tmp_path / "full"), "--device", "cpu"])

    jcfg = jq.quantized_config(s.cfg.replace_gp(max_remain_ratio=0.111, reduce_threshold=0.5))
    prompt = ([jcfg.vision_start_token_id, jcfg.image_token_id, jcfg.vision_end_token_id]
              + StandInTokenizer(cfg)(question))
    prep = jax_runner.prepare_inputs(jcfg, [prompt], [image], seq_multiple=8, patch_multiple=16)
    old = jax_attention.ATTENTION_IMPL
    jax_attention.ATTENTION_IMPL = "flash_interpret"
    try:
        want = jax_runner.GlimpsePruneRunner(jcfg, jq.quantize_int8(s.params)).generate(
            prep, max_new_tokens=6)
    finally:
        jax_attention.ATTENTION_IMPL = old
    np.testing.assert_array_equal(got.sequences, np.asarray(want.sequences))
    np.testing.assert_array_equal(got.keep_img, np.asarray(want.keep_img))
    assert got.keep_img.sum() < got.keep_img.size  # pruned


class _Judge(http.server.BaseHTTPRequestHandler):
    """A stub judge: "score: 0.75" to every request, or garbage when the
    server's ``garbage`` is set."""

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        text = "no verdict" if self.server.garbage else "score: 0.75"
        resp = json.dumps({"choices": [{"message": {"content": text}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(resp)))
        self.end_headers()
        self.wfile.write(resp)

    def log_message(self, *a):
        pass


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    request_queue_size = 16  # at least the client's thread count


@pytest.mark.parametrize("garbage", [False, True])
def test_judge_loadtest_against_a_stub(garbage, monkeypatch):
    """2 threads x 2 requests: the JAX tool's JSON keys and request count;
    a judge answering garbage counts every request as an error (the JAX
    tool scores it 0.0 through LLMClient.score and counts none)."""
    import judge_loadtest as jax_loadtest

    from glimpseprune_torch.tools import judge_loadtest

    with _Server(("127.0.0.1", 0), _Judge) as srv:
        srv.garbage = garbage
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            argv = ["--judge-url", f"http://127.0.0.1:{srv.server_address[1]}", "--threads",
                    "2", "--requests-per-thread", "2"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                got = judge_loadtest.main(argv)
                monkeypatch.setattr(sys, "argv", ["judge_loadtest"] + argv)
                jax_loadtest.main()
        finally:
            srv.shutdown()
    lines = buf.getvalue().strip().splitlines()
    assert json.loads(lines[0]) == got
    want = json.loads(lines[1])
    assert list(got) == list(want)
    assert got["requests"] == want["requests"] == 4
    assert want["errors"] == 0
    assert got["errors"] == (4 if garbage else 0)

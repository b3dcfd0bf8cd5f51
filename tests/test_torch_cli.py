"""The port's command lines on the CPU (``--device cpu``) at the tiny
config: ``train_gp`` (run once as ``python -m`` in a subprocess) trains 2
steps and saves the new modules; ``infer_viscot`` over ``.npy`` images with
that checkpoint writes the records and tokens an in-process
``run_inference`` on the same model gives (generate, glimpse and a
compressor), resumes without touching its output, and gives the same
tokens from a ``--full-params`` checkpoint; ``score_results`` scores them;
``demo`` answers and streams; and a CUDA device without a card is refused,
never replaced by the CPU."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(64, 96), (56, 56), (64, 96), (56, 84)]


def write_inputs(root):
    """The tiny config, a VisCoT-style training jsonl and a VisCoT
    benchmark over the same .npy images, and a JSON trainer config."""
    from glimpseprune_torch.config import tiny_test_config

    tiny_test_config().save(os.path.join(root, "cfg"))
    img_dir = os.path.join(root, "imgs")
    os.makedirs(os.path.join(img_dir, "cot", "toy"))
    rng = np.random.default_rng(0)
    rows, bench = [], []
    for i, (h, w) in enumerate(SIZES):
        np.save(os.path.join(img_dir, "cot", "toy", f"{i}.npy"),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        box = [2, 3, w // 2 + i, h // 2]
        rows.append({"question": f"What is object {i} here?", "answer": f"thing {i}",
                     "image": f"{i}.npy", "width": w, "height": h,
                     "bboxs": [[float(x) for x in box]], "dataset": "toy", "split": "train"})
        name = f"cot/toy/{i}.npy"
        bench.append({"question_id": i, "image": [name, f"{name}###{box}"],
                      "conversations": [{"from": "human", "value": f"<image>\nWhat is {i}?"},
                                        {"from": "gpt", "value": f"thing{i}"}]})
    paths = SimpleNamespace(root=root, cfg=os.path.join(root, "cfg"), img_dir=img_dir,
                            bench=os.path.join(root, "bench.json"),
                            data=os.path.join(root, "data.json"),
                            train=os.path.join(root, "train.json"))
    with open(os.path.join(root, "train.jsonl"), "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    with open(paths.data, "w") as f:
        json.dump({"datasets": [{"json_path": os.path.join(root, "train.jsonl"),
                                 "mapper": "cot_train", "bbox_type": "xyxy",
                                 "additional_mappers": ["norm_bboxes"]}]}, f)
    with open(paths.train, "w") as f:
        json.dump({"batch_size": 2, "seq_multiple": 8, "patch_multiple": 16,
                   "log_every": 1, "save_every": 0}, f)
    with open(paths.bench, "w") as f:
        json.dump(bench, f)
    return paths


def model_args(p):
    return ["--model-config", p.cfg, "--seed", "0", "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Train 2 steps through ``python -m glimpseprune_torch.tools.train_gp``."""
    p = write_inputs(str(tmp_path_factory.mktemp("cli")))
    p.ckpt = os.path.join(p.root, "ckpt")
    proc = subprocess.run(
        [sys.executable, "-m", "glimpseprune_torch.tools.train_gp", "--config", p.train,
         "--data-config", p.data, "--img-dir", p.img_dir, "--output-dir", p.ckpt,
         "--max-steps", "2"] + model_args(p),
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"checkpoint: {p.ckpt}" in proc.stdout
    return p


def in_process_records(p, task, out_dir, name, **icfg):
    """run_inference on a model built as the CLI builds it."""
    import dataclasses

    import torch

    from glimpseprune_torch.config import ModelConfig
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.evalsuite import InferenceConfig, load_benchmark, run_inference
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.persistence import load_new_modules
    from glimpseprune_torch.tools.common import StandInTokenizer, text_codec

    cfg = ModelConfig.load(p.cfg)
    model, saved = load_new_modules(init_random(cfg, 0, "cpu", torch.float32), p.ckpt)
    cfg = dataclasses.replace(cfg, gp=saved.gp)
    tokenize, detokenize = text_codec(StandInTokenizer(cfg))
    out = run_inference(GlimpsePruneRunner(cfg, model.set_config(cfg)),
                        load_benchmark(p.bench, p.img_dir), out_dir, name,
                        InferenceConfig(task=task, batch_size=2, max_new_tokens=6, **icfg),
                        tokenize=tokenize, detokenize=detokenize)
    return read(out)


def read(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def infer_argv(p, task, out_dir, *extra):
    return (["--benchmark", p.bench, "--img-dir", p.img_dir, "--task", task,
             "--batch-size", "2", "--max-new-tokens", "6", "--out-dir", out_dir,
             "--new-modules", p.ckpt] + list(extra) + model_args(p))


def test_train_cli_saves_new_modules(trained):
    from glimpseprune_torch.config import ModelConfig

    for name in ("new_modules_gp.pt", "config.json", "trainer_state.pt", "train_log.json"):
        assert os.path.exists(os.path.join(trained.ckpt, name)), name
    with open(os.path.join(trained.ckpt, "train_log.json")) as f:
        log = json.load(f)
    assert [r["step"] for r in log] == [1, 2] and all(np.isfinite(r["loss"]) for r in log)
    assert ModelConfig.load(trained.ckpt).text.remat


@pytest.mark.parametrize("task", ["generate", "glimpse", "visionzip"])
def test_infer_cli_matches_in_process(task, trained, tmp_path):
    from glimpseprune_torch.tools import infer_viscot

    extra = ["--compressor", "visionzip"] if task == "visionzip" else []
    run = "generate" if task == "visionzip" else task
    out = infer_viscot.main(infer_argv(trained, run, str(tmp_path / "cli"), *extra))
    assert out == str(tmp_path / "cli" / f"bench_{run}.jsonl")
    got = read(out)
    icfg = {"compressor": "visionzip"} if extra else {}
    assert got == in_process_records(trained, run, str(tmp_path / "ref"), "bench", **icfg)
    assert len(got) == 4 and all("iou" in r and "tp" in r for r in got)
    assert all(0 < r["mask_ratio"] <= 1 for r in got)
    if run == "generate":
        assert all(r["num_gen_tokens"] > 0 and r["response"] for r in got)
    with open(out.replace(".jsonl", "_info.json")) as f:
        stats = json.load(f)["logger_stats"]["time_ms"]
    key = {"generate": "generate", "glimpse": "glimpse",
           "visionzip": "generate_compressed"}[task]
    assert {k: v["count"] for k, v in stats.items()} == {f"GlimpsePruneRunner.{key}": 2}

    if task == "generate":  # resume: a second call leaves the file as it is
        mtime = os.stat(out).st_mtime_ns
        assert infer_viscot.main(infer_argv(trained, run, str(tmp_path / "cli"))) == out
        assert os.stat(out).st_mtime_ns == mtime


def test_full_params_source_and_scoring(trained, tmp_path):
    """--full-params gives --model-config's tokens; score_results scores
    the records; demo answers and streams its mask."""
    import torch

    from glimpseprune_torch.config import ModelConfig
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.persistence import save_full_params
    from glimpseprune_torch.tools import demo, infer_viscot, score_results

    cfg = ModelConfig.load(trained.cfg)
    save_full_params(init_random(cfg, 0, "cpu", torch.float32), cfg, str(tmp_path / "full"))
    a = infer_viscot.main(infer_argv(trained, "generate", str(tmp_path / "a")))
    argv = infer_argv(trained, "generate", str(tmp_path / "b"))
    i = argv.index("--model-config")
    argv[i:i + 4] = ["--full-params", str(tmp_path / "full")]
    b = infer_viscot.main(argv)
    assert read(a) == read(b)

    [summary] = score_results.main([a, "--scorer", "precise_match"])
    assert summary["num_scored"] == 4 and summary["mean_score"] == 0.0
    assert score_results.main([a, "--scorer", "dummy_score"])[0]["mean_score"] == 0.0

    image = os.path.join(trained.img_dir, "cot", "toy", "0.npy")
    base = ["--image", image, "--question", "What is it?", "--max-new-tokens", "4",
            "--new-modules", trained.ckpt] + model_args(trained)
    res = demo.main(base)
    streamed = demo.main(base + ["--stream", "--stream-chunk", "3"])
    np.testing.assert_array_equal(streamed.sequences, res.sequences)
    np.testing.assert_array_equal(streamed.keep_img, res.keep_img)


def test_cli_refuses_cuda_without_card(trained, monkeypatch):
    import torch

    from glimpseprune_torch.tools import demo, infer_viscot, train_gp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    image = os.path.join(trained.img_dir, "cot", "toy", "0.npy")
    card = ["--model-config", trained.cfg]
    for main, argv in (
            (train_gp.main, ["--data-config", trained.data] + card),
            (infer_viscot.main, ["--benchmark", trained.bench, "--img-dir", trained.img_dir,
                                 "--out-dir", os.path.join(trained.root, "never")] + card),
            (demo.main, ["--image", image, "--question", "q"] + card)):
        with pytest.raises(SystemExit, match="no CUDA card"):
            main(argv)
    assert not os.path.exists(os.path.join(trained.root, "never"))

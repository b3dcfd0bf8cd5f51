"""The port's FLOPs analysis, oracle retention and mask visualization
(glimpseprune_torch/analysis.py, utils/viz.py) against the JAX package's:
exactly equal outputs on the tiny and the 7B configs; and the port's
profiling decorators (utils/profiling.py): the stats registry, the
inactive loggers' pass-through, debug_calls and the Chrome trace."""

import json
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("tiny", "7b")


def configs(name):
    """(JAX config, port config) of the same sizes."""
    from glimpseprune_tpu import config as jc

    from glimpseprune_torch import config as tc

    if name == "tiny":
        return jc.tiny_test_config(), tc.tiny_test_config()
    d = os.path.join(ROOT, "configs", "model_qwen2_5_7b_gp")
    return jc.ModelConfig.load(d), tc.ModelConfig.load(d)


def write_results(path, token_grids):
    rows = []
    for i, grid in enumerate(token_grids):
        r = {"question_id": i, "num_gen_tokens": [0, 3, 17, None][i % 4],
             "mask_ratio": [0.25, 0.111, 1.0, 0.5][i % 4]}
        if grid:
            r["token_grid"] = grid
        rows.append(r)
    with open(path, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return path


class Sample:
    def __init__(self, boxes, path=""):
        self.normed_bboxes, self.img_path = boxes, path


BOXES = [[[0.1, 0.1, 0.5, 0.6]], None, [[0.0, 0.0, 1.0, 1.0], [0.3, 0.2, 0.4, 0.9]],
         [[0.45, 0.45, 0.55, 0.56]]]
SIZES = [(896, 672), (64, 96), (1000, 3000), (56, 56)]


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_and_retention_match_jax(name, tmp_path):
    from glimpseprune_tpu import analysis as ja

    from glimpseprune_torch import analysis as ta

    jcfg, tcfg = configs(name)

    def run(a, cfg, tag):
        path = write_results(str(tmp_path / f"{tag}.jsonl"),
                             [[2, 3], None, [24, 32], [16, 12], None])
        empty = tmp_path / f"{tag}_empty.jsonl"
        empty.write_text("")
        samples = [Sample(b) for b in BOXES]
        return [
            [a.llm_layer_flops(cfg, s, kv) for s in (1, 64, 832) for kv in (None, 900)],
            [a.vision_flops(cfg, p) for p in (16, 4800, 12544)],
            a.lm_head_flops(cfg, 7),
            a.vanilla_pipeline_flops(cfg, 64, 768, 5),
            [a.gp_pipeline_flops(cfg, 64, 768, k, nd) for k in (0, 85, 768) for nd in (0, 9)],
            a.flops_report_from_results(path, cfg),
            a.flops_report_from_results(path, cfg, n_text=20, n_img_default=300),
            a.flops_report_from_results(str(empty), cfg),
            a.oracle_retention(samples, cfg, image_sizes=SIZES),
            a.oracle_retention(samples, cfg, image_sizes=SIZES, max_pixels=200_000),
            a.oracle_retention([Sample(None)], cfg, image_sizes=[(56, 56)]),
        ]

    assert run(ta, tcfg, "torch") == run(ja, jcfg, "jax")


def test_oracle_retention_reads_image_files(tmp_path):
    """A .npy image's size comes from its header (no PIL), a PNG's through
    PIL, each as JAX's image_sizes give them; JAX reads the PNGs itself."""
    from PIL import Image

    from glimpseprune_tpu import analysis as ja

    from glimpseprune_torch import analysis as ta

    jcfg, tcfg = configs("tiny")
    rng = np.random.default_rng(0)
    png, npy = [], []
    for i, (h, w) in enumerate(SIZES):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        png.append(Sample(BOXES[i], str(tmp_path / f"{i}.png")))
        Image.fromarray(img).save(png[-1].img_path)
        npy.append(Sample(BOXES[i], str(tmp_path / f"{i}.npy")))
        np.save(npy[-1].img_path, img)
    want = ja.oracle_retention(png, jcfg)
    assert want == ja.oracle_retention(png, jcfg, image_sizes=SIZES)
    assert ta.oracle_retention(png, tcfg) == want
    assert ta.oracle_retention(npy, tcfg) == want


def test_viz_matches_jax():
    from glimpseprune_tpu.utils import viz as jv

    from glimpseprune_torch.utils import viz as tv

    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, (61, 97, 3), dtype=np.uint8)
    for shape in ((4, 6), (1, 1), (61, 97)):
        mask = rng.random(shape) > 0.5
        for kw in ({}, {"alpha": 0.8, "dim_color": (255, 0, 10)}):
            got = tv.apply_mask_on_image(image, mask, **kw)
            want = jv.apply_mask_on_image(image, mask, **kw)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert tv.ascii_mask(mask) == jv.ascii_mask(mask)
        assert tv.ascii_mask(mask, "x", " ") == jv.ascii_mask(mask, "x", " ")


def profiled_runner():
    """A class whose methods carry the decorators, as the runner's do
    (module-level, so that its qualified names are the stats' keys)."""
    import torch

    from glimpseprune_torch.utils import profiling as p

    global Runner

    class Runner:
        device = torch.device("cpu")
        calls = []

        @p.time_logger
        @p.debug_calls()
        def work(self, x):
            self.calls.append(x)
            return x * 2

        @p.memory_logger
        def mem(self, x):
            return x + 1

    return Runner()


def test_profiling_registry_and_pass_through(monkeypatch, capsys, tmp_path):
    import torch

    from glimpseprune_torch.utils import profiling as p

    r = profiled_runner()
    calls = r.calls
    p.reset_logger_stats()
    assert r.work(torch.ones(2)).tolist() == [2.0, 2.0]  # inactive: no stats
    assert p.get_logger_stats() == {"time_ms": {}, "peak_memory_bytes": {}}
    with p.LoggerControl(time_active=True, memory_active=True):
        r.work(torch.ones(3))
        r.work(torch.ones(3))
        assert r.mem(1) == 2
        with p.time_logger_set_active(False):
            r.work(torch.ones(1))
    stats = p.get_logger_stats()
    assert list(stats["time_ms"]) == ["Runner.work"]
    t = stats["time_ms"]["Runner.work"]
    assert t["count"] == 2 and t["total"] >= t["avg"] > 0
    assert stats["peak_memory_bytes"] == {"Runner.mem": {"peak": 0.0, "count": 1}}
    with p.memory_logger_set_active(True):
        r.mem(2)
    assert p.get_logger_stats()["peak_memory_bytes"]["Runner.mem"]["count"] == 2
    assert not p._flag("time_active") and not p._flag("memory_active")
    p.reset_logger_stats()
    assert p.get_logger_stats() == {"time_ms": {}, "peak_memory_bytes": {}}

    monkeypatch.setenv("DEBUG_CALLS_N", "2")
    for _ in range(4):
        r.work(torch.zeros(5))
    out = capsys.readouterr().out.splitlines()
    assert out == [f"[debug_calls] Runner.work #{n} (Runner, Tensor{torch.Size([5])})"
                   for n in (2, 4)]
    assert len(calls) == 8

    with p.profiler_trace(str(tmp_path / "trace")):
        r.work(torch.ones(4))
    with open(tmp_path / "trace" / p.profiler_trace.TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)
    with p.profiler_trace(None) as off:
        r.work(torch.ones(4))
    assert off._prof is None

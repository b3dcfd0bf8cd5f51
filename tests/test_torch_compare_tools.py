"""The port's result-comparison tools and attention-map dump against the JAX
package's (tools/compare_results.py, tools/compare_server.py,
tools/save_attn_maps.py): compare_results prints and writes the same
report, compare_server serves the same pages and filters over
tests/test_compare_server.py's fixtures, and its overlay PNG holds the
pixels of JAX's PIL overlay; save_attn_maps' heatmaps equal JAX's within
1e-5 on shared tiny weights, under the same file names; the stdlib PNG
encoder round-trips through PIL."""

import contextlib
import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from test_compare_server import result_dirs  # noqa: E402,F401  (the JAX test's fixture)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def test_compare_results_equals_jax(result_dirs, tmp_path, monkeypatch):  # noqa: F811
    import compare_results as jax_compare

    from glimpseprune_torch.tools import compare_results

    a, b = result_dirs
    outs = []
    for name, run in (("jax", lambda argv: (monkeypatch.setattr(sys, "argv", ["x"] + argv),
                                            jax_compare.main())),
                      ("port", compare_results.main)):
        buf = io.StringIO()
        path = str(tmp_path / f"{name}.json")
        with contextlib.redirect_stdout(buf):
            run([a, b, "--show", "2", "--json-out", path])
        with open(path) as f:
            outs.append((buf.getvalue(), json.load(f)))
    assert outs[0] == outs[1]
    assert outs[1][1]["common_samples"] == 3 and "score" in outs[1][1]["metrics"]


@pytest.mark.parametrize("filters", [[], ["--filter-a-gt-b"], ["--filter-a-lt-b"],
                                     ["--filter-iou-lt", "0.65"], ["--filter-ratio-lt", "0.05"]])
def test_compare_server_equals_jax(result_dirs, filters):  # noqa: F811
    import compare_server as jax_server
    from PIL import Image

    from glimpseprune_torch.tools import compare_server

    a, b = result_dirs
    jax_state = jax_server.CompareState(jax_server.parse_args([a, b] + filters))
    jax_srv = ThreadingHTTPServer(("127.0.0.1", 0), jax_server.make_handler(jax_state))
    srv = compare_server.make_server(compare_server.parse_args([a, b, "--port", "0"] + filters))
    assert srv.RequestHandlerClass.state.ids == jax_state.ids
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in (jax_srv, srv)]
    for t in threads:
        t.start()
    try:
        ports = [s.server_address[1] for s in (jax_srv, srv)]
        paths = ["/", "/nope"] + [f"/sample/{i}" for i in range(len(jax_state.ids))]
        for path in paths:
            want, got = (_get(p, path) for p in ports)
            assert got == want, path
        for side in ("a", "b") if jax_state.ids else ():
            want, got = (_get(p, f"/img/0/{side}") for p in ports)
            assert got[:2] == want[:2] == (200, "image/png")
            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(got[2]))),
                                          np.asarray(Image.open(io.BytesIO(want[2]))))
    finally:
        for s in (jax_srv, srv):
            s.shutdown()
            s.server_close()


def test_compare_server_npy_overlay(tmp_path):
    """A .npy image renders without PIL's decoder: the mask scaled up by
    nearest neighbour, blended at alpha over the kept tokens."""
    from glimpseprune_torch.tools import compare_server
    from glimpseprune_torch.utils.viz import decode_png

    img = np.random.default_rng(1).integers(0, 256, (30, 45, 3), dtype=np.uint8)
    np.save(tmp_path / "x.npy", img)
    row = {"question_id": "q0", "img_path": "x.npy", "response": "r", "keep_mask": [1, 0, 0, 1,
                                                                                      1, 0],
           "token_grid": [2, 3]}
    for name in ("a", "b"):
        (tmp_path / f"{name}.jsonl").write_text(json.dumps(row) + "\n")
    srv = compare_server.make_server(compare_server.parse_args(
        [str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl"), "--img-dir", str(tmp_path),
         "--port", "0"]))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        code, ctype, png = _get(srv.server_address[1], "/img/0/a")
    finally:
        srv.shutdown()
        srv.server_close()
    out = decode_png(png)
    assert (code, ctype, out.shape) == (200, "image/png", img.shape)
    kept = np.array([[1, 0, 0], [1, 1, 0]], bool)[np.arange(30) * 2 // 30][:, np.arange(45) * 3
                                                                           // 45]
    np.testing.assert_array_equal(out[~kept], img[~kept])
    assert (out[kept][:, 1].astype(int) >= img[kept][:, 1]).all()


def test_png_roundtrip_through_pil():
    from PIL import Image

    from glimpseprune_torch.utils.viz import decode_png, encode_png

    for shape in ((1, 1, 3), (37, 53, 3), (64, 96, 3)):
        a = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
        data = encode_png(a)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), a)
        np.testing.assert_array_equal(decode_png(data), a)
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.uint8))


def test_save_attn_maps_equals_jax(tmp_path, monkeypatch):
    """Both tools on JAX's --tiny model and tokenizer, the port's model
    holding JAX's weights: every file JAX writes is written by the port too,
    and the port's heatmaps equal JAX's (the fused maps from JAX's mask
    logits, the multi-query maps from JAX's npz) within 1e-5."""
    import save_attn_maps as jax_tool
    from PIL import Image

    import tools.demo as jax_demo

    from glimpseprune_tpu.models.qwen2_5_vl.runner import GlimpsePruneRunner, prepare_inputs

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.tools import common, save_attn_maps
    from glimpseprune_torch.tools.demo_server import TinyTok

    cfg_j, params, tok_j = jax_demo.make_tiny()
    img = np.random.default_rng(2).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "img.png")
    q, question = 6, "what is this"
    monkeypatch.setattr(sys, "argv", ["x", "--image", str(tmp_path / "img.png"), "--question",
                                      question, "--tiny", "--q-start", str(q), "--out-dir",
                                      str(tmp_path / "jax")])
    jax_tool.main()
    cfg = tiny_test_config()
    model = load_from_jax(params, cfg, device="cpu").set_config(cfg)
    monkeypatch.setattr(common, "load_model", lambda args: (cfg, model, TinyTok()))
    out = save_attn_maps.main(["--image", str(tmp_path / "img.png"), "--question", question,
                               "--q-start", str(q), "--per-head", "--out-dir",
                               str(tmp_path / "port"), "--model-config", "unused",
                               "--device", "cpu"])
    jax_files = sorted(os.listdir(tmp_path / "jax"))
    assert set(jax_files) <= set(os.listdir(tmp_path / "port")) and jax_files
    assert set(jax_files) <= set(out["files"])

    prompt = [cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id] + \
        tok_j(question)
    prep = prepare_inputs(cfg_j, [prompt], [img], seq_multiple=8, patch_multiple=16)
    ml, _ = GlimpsePruneRunner(cfg_j, params).glimpse_delayed(prep)
    ml = np.asarray(ml)
    gh, gw = out["grid"]
    want = {}
    for i in range(ml.shape[0]):
        want[f"fused_map_{i}.png"] = save_attn_maps.normalize(
            1 / (1 + np.exp(-ml[i, 0, : gh * gw])).reshape(gh, gw))
    for name in jax_files:
        if name.endswith(".npz"):
            layer = name[len("seq_attns_layer"):-len(".npz")]
            attns = np.load(tmp_path / "jax" / name)["attns"]
            np.testing.assert_allclose(np.load(tmp_path / "port" / name)["attns"], attns,
                                       rtol=0, atol=1e-5)
            mean = attns[:, : gh * gw].mean(-1)
            for qi in range(mean.shape[0]):
                want[f"seq_attn_l{layer}_q{qi:03d}.png"] = save_attn_maps.normalize(
                    mean[qi].reshape(gh, gw))
    assert set(want) == {f for f in jax_files if f.endswith(".png")}
    for name, amap in want.items():
        np.testing.assert_allclose(out["heatmaps"][name], amap, rtol=0, atol=1e-5,
                                   err_msg=name)

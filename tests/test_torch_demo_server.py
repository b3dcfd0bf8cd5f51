"""The port's browser demo server (glimpseprune_torch/tools/demo_server.py)
against the JAX package's (tools/demo_server.py) on shared tiny weights
(JAX's ``--tiny`` model, loaded into the port): over a real HTTP round trip
on port 0 the port's token events equal JAX's ``DemoState.generate_events``
with GP on and off, its ``done`` event's prune_ratio and n_tokens equal
JAX's, and its overlay PNG decodes through PIL to JAX's overlay pixels.
JAX gets the image as a PNG, the port the same pixels as ``image_npy``. A
bad payload gives an ``error`` event."""

import base64
import io
import json
import os
import sys
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


@pytest.fixture(scope="module")
def states():
    import demo_server as jax_demo

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.tools import demo_server

    jax_state = jax_demo.DemoState(SimpleNamespace(tiny=True, hf_model=None, new_modules=None,
                                                   int8=False))
    cfg = tiny_test_config()
    model = load_from_jax(jax_state.params, cfg, device="cpu").set_config(cfg)
    args = demo_server.parse_args(["--tiny", "--device", "cpu"])
    return jax_state, demo_server.DemoState(args, cfg=cfg, model=model,
                                            tok=demo_server.TinyTok())


def _post(base, payload):
    req = urllib.request.Request(base + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200 and r.headers.get("Content-Type") == "text/event-stream"
        body = r.read().decode()
    return [json.loads(b[6:]) for b in body.split("\n\n") if b.startswith("data: ")]


def test_demo_server_matches_jax(states):
    from PIL import Image

    from glimpseprune_torch.tools import demo_server

    jax_state, state = states
    srv = demo_server.make_server(state)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        page = urllib.request.urlopen(base + "/", timeout=30).read().decode()
        assert "GlimpsePrune" in page and "max remain ratio" in page
        img = np.random.default_rng(0).integers(0, 255, (64, 96, 3), dtype=np.uint8)
        png, npy = io.BytesIO(), io.BytesIO()
        Image.fromarray(img).save(png, format="PNG")
        np.save(npy, img)
        for sel in (True, False):
            common = {"question": "hi there", "do_selection": sel, "max_remain_ratio": 0.3,
                      "reduce_threshold": 0.5, "max_new_tokens": 6}
            want = list(jax_state.generate_events(
                {**common, "image": base64.b64encode(png.getvalue()).decode()}))
            got = _post(base, {**common,
                               "image_npy": base64.b64encode(npy.getvalue()).decode()})
            assert [e for e in got if e["type"] == "token"] == \
                [e for e in want if e["type"] == "token"]
            g, w = got[-1], want[-1]
            assert g["type"] == w["type"] == "done"
            assert g["n_tokens"] == w["n_tokens"]
            if sel:
                assert g["prune_ratio"] == pytest.approx(w["prune_ratio"], abs=1e-7)
                over = [np.asarray(Image.open(io.BytesIO(base64.b64decode(e["overlay"]))))
                        for e in (g, w)]
                np.testing.assert_array_equal(over[0], over[1])
            else:
                assert g["prune_ratio"] is None and g["overlay"] is None
        assert list(state._runners) == list(jax_state._runners) == [(0.3, 0.5)]

        for bad in ({"question": "no image"}, {"image_npy": "bm90IGFuIGFycmF5"},
                    {"image_npy": base64.b64encode(npy.getvalue()[:40]).decode()}):
            events = _post(base, bad)
            assert [e["type"] for e in events] == ["error"] and events[0]["message"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)

"""Browser demo server; counterpart of tools/demo_server.py (the
reference's Gradio UI, demo_gp.py:220-247, on the standard library's HTTP
server).

One page: an image upload, a question, GlimpsePrune on or off, the
max-remain-ratio and reduce-threshold sliders, the answer streamed as
Server-Sent Events (``POST /generate``: token events from
``runner.stream_generate(chunk_size=4)`` with GP on, one from
``generate(do_selection=False)`` with it off), then a ``done`` event with
``prune_ratio``, ``n_tokens`` and the kept-token overlay
(``utils/viz.apply_mask_on_image``, PNG from ``utils/viz.encode_png``). An
error reaches the page as an ``error`` event.

Each slider tuple (ratio, threshold) has its runner, made at its first
request; all runners share one model, which is bound to the runner's
config for each request, and each runner captures its own decode step
(two tuples, two captures: ``DemoState.requests`` records each request's
capture ms). Images: ``image`` is a base64 PNG / JPEG (decoded with PIL),
``image_npy`` the base64 bytes of ``np.save`` of an [H, W, 3] uint8 array
(no PIL needed, as on the card); ``--native-preproc`` resizes them without
PIL.

  python -m glimpseprune_torch.tools.demo_server --tiny --device cpu
  python -m glimpseprune_torch.tools.demo_server --model-config configs/model_qwen2_5_7b_gp \
      --seed 0 --native-preproc --port 7860
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>GlimpsePrune demo</title>
<style>
 body{font-family:sans-serif;max-width:900px;margin:24px auto;padding:0 12px}
 #row{display:flex;gap:16px}  #left,#right{flex:1}
 img{max-width:100%;border:1px solid #ccc}
 #answer{white-space:pre-wrap;border:1px solid #ccc;min-height:80px;padding:8px}
 label{display:block;margin-top:8px}
</style></head><body>
<h2>GlimpsePrune — visual token pruning demo</h2>
<div id="row"><div id="left">
 <input type="file" id="img" accept="image/*"><br>
 <img id="preview" hidden>
 <label>Question <input id="q" size="50" value="What is in the image?"></label>
 <label><input type="checkbox" id="gp" checked> GlimpsePrune enabled</label>
 <label>max remain ratio <input id="ratio" type="range" min="0.02" max="1.0"
   step="0.01" value="0.111"> <span id="ratio_v">0.111</span></label>
 <label>reduce threshold <input id="thr" type="range" min="0" max="1"
   step="0.05" value="0.5"> <span id="thr_v">0.5</span></label>
 <label>max new tokens <input id="maxnew" type="number" value="128"></label>
 <button id="go">Generate</button>
</div><div id="right">
 <h4>Answer</h4><div id="answer"></div>
 <h4>Kept tokens <span id="stats"></span></h4><img id="overlay" hidden>
</div></div>
<script>
const $=id=>document.getElementById(id);
$('ratio').oninput=()=>$('ratio_v').textContent=$('ratio').value;
$('thr').oninput=()=>$('thr_v').textContent=$('thr').value;
let imgB64=null;
$('img').onchange=e=>{const f=e.target.files[0];const r=new FileReader();
 r.onload=()=>{imgB64=r.result.split(',')[1];$('preview').src=r.result;
  $('preview').hidden=false};r.readAsDataURL(f);};
$('go').onclick=async()=>{
 if(!imgB64){alert('choose an image');return}
 $('answer').textContent='';$('overlay').hidden=true;$('stats').textContent='…';
 const res=await fetch('/generate',{method:'POST',headers:{'Content-Type':
  'application/json'},body:JSON.stringify({image:imgB64,question:$('q').value,
  do_selection:$('gp').checked,max_remain_ratio:+$('ratio').value,
  reduce_threshold:+$('thr').value,max_new_tokens:+$('maxnew').value})});
 const rd=res.body.getReader();const dec=new TextDecoder();let buf='';
 for(;;){const{done,value}=await rd.read();if(done)break;
  buf+=dec.decode(value,{stream:true});
  for(let i;(i=buf.indexOf('\\n\\n'))>=0;){const ev=buf.slice(0,i);buf=buf.slice(i+2);
   if(!ev.startsWith('data: '))continue;const d=JSON.parse(ev.slice(6));
   if(d.type=='token')$('answer').textContent+=d.text;
   else if(d.type=='done'){$('stats').textContent=
     d.prune_ratio!=null?`pruned ${(d.prune_ratio*100).toFixed(1)}% of ${d.n_tokens} tokens`:'';
    if(d.overlay){$('overlay').src='data:image/png;base64,'+d.overlay;
     $('overlay').hidden=false}}
   else if(d.type=='error')$('answer').textContent+='\\n[error] '+d.message;}}
};
</script></body></html>"""


class TinyTok:
    """The JAX demo's tokenizer of the tiny model (tools/demo.py
    ``make_tiny``): one id a character of the first 32, ids written back
    as numbers."""

    def __call__(self, text):
        return [5 + ord(c) % 400 for c in text[:32]]

    def encode(self, text, add_special_tokens: bool = False):
        return self(text)

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))


def decode_image(payload: dict) -> np.ndarray:
    """The request's image as [H, W, 3] uint8: ``image_npy`` (base64 of
    ``np.save`` bytes) or ``image`` (base64 PNG / JPEG, through PIL)."""
    if payload.get("image_npy"):
        arr = np.load(io.BytesIO(base64.b64decode(payload["image_npy"])), allow_pickle=False)
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(f"image_npy: an [H, W, 3] uint8 array, not {arr.dtype} {arr.shape}")
        return arr
    if not payload.get("image"):
        raise ValueError("the request carries no image (image or image_npy)")
    from PIL import Image

    with Image.open(io.BytesIO(base64.b64decode(payload["image"]))) as im:
        return np.asarray(im.convert("RGB"))


class DemoState:
    """One model + a runner cache keyed by the slider tuple. ``cfg``,
    ``model`` and ``tok`` may be given (shared weights); otherwise they come
    from ``args`` (``--tiny``: the tiny test config with random weights from
    ``--seed``; else ``tools/common.load_model``), ``--int8`` quantizing
    the model (q8: int8 weights, W8A8 prefill)."""

    def __init__(self, args, cfg=None, model=None, tok=None):
        from glimpseprune_torch.tools.common import load_model, resolve_device

        self.args = args
        if model is None:
            if args.tiny:
                from glimpseprune_torch.config import tiny_test_config
                from glimpseprune_torch.convert import init_random

                import torch

                dev = resolve_device(args.device)
                cfg = tiny_test_config()
                dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
                model = init_random(cfg, args.seed, dev, dtype).set_config(cfg)
                tok = TinyTok()
            else:
                cfg, model, tok = load_model(args)
        if args.int8:
            from glimpseprune_torch.quantization import quantize_model, quantized_config

            cfg = quantized_config(cfg, act_quant="prefill")
            quantize_model(model, "int8", cfg=cfg)
        self.cfg, self.model, self.tok = cfg, model, tok
        self.native = True if getattr(args, "native_preproc", False) else None
        self._runners = {}
        self.requests = []  # per request: the runner key, its ms, capture ms
        self.lock = threading.Lock()  # one card: one generate at a time

    def runner(self, ratio: float, threshold: float):
        from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

        key = (round(ratio, 4), round(threshold, 4))
        if key not in self._runners:
            cfg = self.cfg.replace_gp(max_remain_ratio=ratio, reduce_threshold=threshold)
            self.model.set_config(cfg)
            self._runners[key] = GlimpsePruneRunner(cfg, self.model)
        return self._runners[key]

    def generate_events(self, payload):
        """Yield the SSE event dicts of one request (tokens, then done)."""
        from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
        from glimpseprune_torch.utils.viz import apply_mask_on_image, encode_png

        t0 = time.perf_counter()
        image = decode_image(payload)
        question = payload.get("question", "")
        ratio = float(payload.get("max_remain_ratio", 0.111))
        threshold = float(payload.get("reduce_threshold", 0.5))
        do_selection = bool(payload.get("do_selection", True))
        max_new = int(payload.get("max_new_tokens", 128))

        tok = self.tok
        ids = list(tok(question) if callable(tok) else tok.encode(question))
        with self.lock:
            runner = self.runner(ratio, threshold)
            cfg = runner.cfg
            self.model.set_config(cfg)
            prompt = ([cfg.vision_start_token_id, cfg.image_token_id,
                       cfg.vision_end_token_id] + ids)
            prep = prepare_inputs(cfg, [prompt], [image], seq_multiple=8, patch_multiple=16,
                                  use_native_preproc=self.native)
            graphs = dict(runner.decode_graphs._graphs)
            if do_selection:
                gen = runner.stream_generate(prep, max_new_tokens=max_new, chunk_size=4)
                res = None
                while True:
                    try:
                        toks = next(gen)
                    except StopIteration as stop:
                        res = stop.value
                        break
                    piece = [int(x) for x in toks[0] if int(x) != cfg.eos_token_id]
                    if piece:
                        yield {"type": "token",
                               "text": tok.decode(piece, skip_special_tokens=True)}
                    if len(piece) < toks.shape[1]:
                        break
                while res is None:
                    try:
                        next(gen)
                    except StopIteration as stop:
                        res = stop.value
            else:
                res = runner.generate(prep, max_new_tokens=max_new, do_selection=False)
                text = tok.decode([int(x) for x in res.sequences[0, : res.num_generated[0]]],
                                  skip_special_tokens=True)
                yield {"type": "token", "text": text}
            new = [g for k, g in runner.decode_graphs._graphs.items() if graphs.get(k) is not g]
            self.requests.append({
                "key": [ratio, threshold], "do_selection": do_selection,
                "ms": 1e3 * (time.perf_counter() - t0),
                "capture_ms": [1e3 * g.capture_s for g in new],
                "sequences": res.sequences[0, : res.num_generated[0]].tolist()})

        done = {"type": "done", "prune_ratio": None, "n_tokens": None, "overlay": None}
        if res.keep_img is not None and do_selection:
            gh = int(prep.grids[0][1] // cfg.vision.spatial_merge_size)
            gw = int(prep.grids[0][2] // cfg.vision.spatial_merge_size)
            mask = np.asarray(res.keep_img[0, : gh * gw]).reshape(gh, gw)
            done.update(prune_ratio=float(res.prune_ratio[0]), n_tokens=gh * gw,
                        overlay=base64.b64encode(
                            encode_png(apply_mask_on_image(image, mask))).decode())
        yield done


def make_handler(state: DemoState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path not in ("/", "/index.html"):
                self.send_error(404)
                return
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                for ev in state.generate_events(payload):
                    self.wfile.write(
                        f"data: {json.dumps(ev)}\n\n".encode())
                    self.wfile.flush()
            except BrokenPipeError:
                pass
            except Exception as e:  # surface model errors to the page
                try:
                    self.wfile.write(
                        ("data: " + json.dumps(
                            {"type": "error", "message": str(e)}) + "\n\n")
                        .encode())
                except BrokenPipeError:
                    pass

    return Handler


def make_server(state: DemoState, host: str = "127.0.0.1", port: int = 0):
    """The server over ``state`` (not yet serving; port 0 picks a free port:
    ``server_address[1]``)."""
    return ThreadingHTTPServer((host, port), make_handler(state))


def parse_args(argv: Optional[Sequence[str]] = None):
    from glimpseprune_torch.tools.common import add_model_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny test config with random weights (no model source)")
    ap.add_argument("--int8", action="store_true", help="quantize to (q8) after loading")
    ap.add_argument("--native-preproc", action="store_true",
                    help="resize images with the native C++ prep (no PIL)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    argv = list(sys.argv[1:] if argv is None else argv)
    add_model_args(ap, default_config="" if "--tiny" in argv else None)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Serve until interrupted."""
    args = parse_args(argv)
    state = DemoState(args)
    srv = make_server(state, args.host, args.port)
    print(f"demo server on http://{srv.server_address[0]}:{srv.server_address[1]}  "
          f"(model: {'tiny' if args.tiny else args.model_config or args.hf_model or args.full_params})")
    srv.serve_forever()


if __name__ == "__main__":
    main()

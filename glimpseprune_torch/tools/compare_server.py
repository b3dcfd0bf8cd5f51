"""Browser UI for side-by-side comparison of two eval result jsonls;
counterpart of tools/compare_server.py (the reference's Gradio results
browser, results_vis_compare.py:17-357, on the standard library's HTTP
server).

  python -m glimpseprune_torch.tools.compare_server results/a_generate.jsonl \
      results/b_generate.jsonl [--img-dir DIR] [--port 7870]

Rows are joined on ``question_id``; ``*_score.jsonl`` files beside each
input are picked up (as ``compare_results`` does). A mask overlay renders
where a row carries ``keep_mask`` + ``token_grid`` (``infer_viscot
--save-masks``) and its image resolves through ``img_path`` / ``--img-dir``:
the mask is scaled up nearest-neighbour in numpy and the PNG written by
``utils/viz.encode_png``, so only an image that is not ``.npy`` needs PIL
(to open it). Filters as the reference's: ``--filter-a-gt-b`` /
``--filter-a-lt-b`` (score), ``--filter-iou-lt X``, ``--filter-ratio-lt X``
(on side A).
"""

from __future__ import annotations

import argparse
import html
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence
from urllib.parse import urlparse

import numpy as np

from glimpseprune_torch.evalsuite.data import load_image
from glimpseprune_torch.tools.compare_results import load_jsonl, load_scores
from glimpseprune_torch.utils.viz import encode_png


def blend_mask(image: np.ndarray, mask: np.ndarray, color: str, alpha: float) -> np.ndarray:
    """``color`` ("#RRGGBB") pasted over image [H, W, 3] uint8 where the
    token mask [gh, gw] is set, at opacity alpha: the mask scaled up
    nearest-neighbour (pixel centres), the blend in PIL's integer paste
    arithmetic (an 8-bit mask of 255 * alpha)."""
    h, w = image.shape[:2]
    gh, gw = mask.shape
    ys = np.minimum(((np.arange(h) + 0.5) * gh / h).astype(np.int64), gh - 1)
    xs = np.minimum(((np.arange(w) + 0.5) * gw / w).astype(np.int64), gw - 1)
    a = (mask[ys[:, None], xs[None, :]].astype(np.float64) * 255 * alpha).astype(np.uint8)
    a = a.astype(np.int64)[..., None]
    rgb = np.array([int(color.lstrip("#")[i:i + 2], 16) for i in (0, 2, 4)], np.int64)
    tmp = image.astype(np.int64) * (255 - a) + rgb * a + 128
    return ((tmp + (tmp >> 8)) >> 8).astype(np.uint8)


class CompareState:
    def __init__(self, args):
        self.args = args
        self.A = load_jsonl(args.a)
        self.B = load_jsonl(args.b)
        self.sa = load_scores(args.a)
        self.sb = load_scores(args.b)
        self.ids = [k for k in self.A if k in self.B]
        self.ids = [k for k in self.ids if self._keep(k)]

    def _keep(self, k):
        a, sa, sb = self.A[k], self.sa.get(k), self.sb.get(k)
        f = self.args
        if f.filter_a_gt_b and not (
            sa is not None and sb is not None and sa > sb
        ):
            return False
        if f.filter_a_lt_b and not (
            sa is not None and sb is not None and sa < sb
        ):
            return False
        if f.filter_iou_lt is not None and not (
            a.get("iou") is not None and a["iou"] < f.filter_iou_lt
        ):
            return False
        if f.filter_ratio_lt is not None and not (
            a.get("mask_ratio") is not None
            and a["mask_ratio"] < f.filter_ratio_lt
        ):
            return False
        return True

    def resolve_image(self, row):
        p = row.get("img_path")
        if not p:
            return None
        cands = [p]
        if self.args.img_dir:
            cands.append(os.path.join(self.args.img_dir, p))
            cands.append(os.path.join(self.args.img_dir, os.path.basename(p)))
        for c in cands:
            if os.path.exists(c):
                return c
        return None

    def overlay_png(self, side, idx):
        """The source image with the keep-mask overlay (``--color`` over the
        kept tokens at ``--alpha``), reference apply_mask_on_image semantics
        (demo_gp.py:23-52), as PNG bytes."""
        row = (self.A if side == "a" else self.B)[self.ids[idx]]
        img_path = self.resolve_image(row)
        if img_path is None:
            return None
        img = load_image(img_path)
        mask, grid = row.get("keep_mask"), row.get("token_grid")
        if mask and grid:
            gh, gw = int(grid[0]), int(grid[1])
            m = np.asarray(mask[: gh * gw], dtype=np.uint8).reshape(gh, gw)
            img = blend_mask(img, m, self.args.color, self.args.alpha)
        return encode_png(img)

    def aggregates(self):
        out = {}
        for key in ("iou", "mask_ratio", "num_gen_tokens"):
            for side, rows, scores in (("a", self.A, self.sa),
                                       ("b", self.B, self.sb)):
                vals = [rows[k].get(key) for k in self.ids
                        if rows[k].get(key) is not None]
                if vals:
                    out.setdefault(key, {})[side] = float(np.mean(vals))
        if self.sa and self.sb:
            out["score"] = {
                "a": float(np.mean([self.sa[k] for k in self.ids
                                    if k in self.sa] or [np.nan])),
                "b": float(np.mean([self.sb[k] for k in self.ids
                                    if k in self.sb] or [np.nan])),
            }
        return out


PAGE = """<!doctype html><html><head><title>GP results compare</title><style>
body{{font-family:sans-serif;margin:1.5em;background:#fafafa}}
table{{border-collapse:collapse}} td,th{{border:1px solid #ccc;padding:4px 10px}}
.cols{{display:flex;gap:1.5em}} .panel{{flex:1;background:#fff;border:1px solid
#ddd;padding:1em;border-radius:6px}} img{{max-width:100%;border:1px solid #eee}}
.resp{{white-space:pre-wrap;background:#f4f6f8;padding:.6em;border-radius:4px}}
.nav a{{margin-right:1em}}</style></head><body>{body}</body></html>"""


def make_handler(state: CompareState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, data, ctype="text/html"):
            body = data.encode() if isinstance(data, str) else data
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if not parts:
                return self._send(PAGE.format(body=self._index()))
            if parts[0] == "sample" and len(parts) == 2:
                return self._send(PAGE.format(body=self._sample(int(parts[1]))))
            if parts[0] == "img" and len(parts) == 3:
                png = state.overlay_png(parts[2], int(parts[1]))
                if png is None:
                    self.send_response(404)
                    self.end_headers()
                    return None
                return self._send(png, "image/png")
            self.send_response(404)
            self.end_headers()
            return None

        def _index(self):
            agg = state.aggregates()
            rows = "".join(
                f"<tr><td>{html.escape(k)}</td>"
                f"<td>{v.get('a', float('nan')):.4g}</td>"
                f"<td>{v.get('b', float('nan')):.4g}</td></tr>"
                for k, v in agg.items()
            )
            links = "".join(
                f'<li><a href="/sample/{i}">{html.escape(str(qid))}</a>'
                f" — A:{state.sa.get(qid, '-')}"
                f" B:{state.sb.get(qid, '-')}</li>"
                for i, qid in enumerate(state.ids[:500])
            )
            return (
                f"<h2>{html.escape(os.path.basename(state.args.a))} (A) vs "
                f"{html.escape(os.path.basename(state.args.b))} (B)</h2>"
                f"<p>{len(state.ids)} joined samples (after filters)</p>"
                f"<table><tr><th>metric</th><th>A</th><th>B</th></tr>{rows}"
                f"</table><h3>Samples</h3><ul>{links}</ul>"
            )

        def _sample(self, i):
            i = max(0, min(i, len(state.ids) - 1))
            qid = state.ids[i]
            a, b = state.A[qid], state.B[qid]

            def panel(side, row, score):
                img_html = (
                    f'<img src="/img/{i}/{side}">'
                    if state.resolve_image(row) else "<i>(no image)</i>"
                )
                stats = " ".join(
                    f"{k}={row[k]:.3f}" for k in ("iou", "mask_ratio")
                    if isinstance(row.get(k), float)
                )
                return (
                    f'<div class="panel"><h3>{side.upper()}'
                    f" — score {score if score is not None else '-'}"
                    f"</h3>{img_html}"
                    f'<p>{stats}</p><div class="resp">'
                    f"{html.escape(str(row.get('response')))}</div></div>"
                )

            nav = (
                f'<div class="nav"><a href="/">index</a>'
                f'<a href="/sample/{i - 1}">prev</a>'
                f'<a href="/sample/{i + 1}">next</a> sample {i + 1}/'
                f"{len(state.ids)}</div>"
            )
            return (
                f"{nav}<h2>{html.escape(str(qid))}</h2>"
                f"<p><b>Q:</b> {html.escape(str(a.get('query')))}</p>"
                f"<p><b>GT:</b> {html.escape(str(a.get('answer')))}</p>"
                f'<div class="cols">'
                f"{panel('a', a, state.sa.get(qid))}"
                f"{panel('b', b, state.sb.get(qid))}</div>"
            )

    Handler.state = state
    return Handler


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--img-dir", default=None)
    ap.add_argument("--color", default="#00FF00")
    ap.add_argument("--alpha", type=float, default=0.4)
    ap.add_argument("--filter-a-gt-b", action="store_true")
    ap.add_argument("--filter-a-lt-b", action="store_true")
    ap.add_argument("--filter-iou-lt", type=float, default=None)
    ap.add_argument("--filter-ratio-lt", type=float, default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7870)
    return ap.parse_args(argv)


def make_server(args) -> ThreadingHTTPServer:
    """The server over the two files (not yet serving; port 0 picks a free
    port: ``server_address[1]``)."""
    return ThreadingHTTPServer((args.host, args.port), make_handler(CompareState(args)))


def main(argv: Optional[Sequence[str]] = None):
    """Serve until interrupted."""
    srv = make_server(parse_args(argv))
    state = srv.RequestHandlerClass.state
    print(f"compare server on http://{srv.server_address[0]}:{srv.server_address[1]} "
          f"({len(state.ids)} samples)")
    srv.serve_forever()


if __name__ == "__main__":
    main()

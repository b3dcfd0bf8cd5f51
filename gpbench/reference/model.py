"""Plain PyTorch reference of Qwen2.5-VL with GlimpsePrune, in float32.

It follows the published Qwen2.5-VL forward (patchify, windowed ViT with
2-D rope and full-attention blocks, the 2x2 merger, the decoder with 3-D
mRoPE) and the GlimpsePrune recipe (glimpse embeddings at the glimpse
slot, the glimpse query's attention row harvested at the selected layer,
the conditioned AttnFuserV1, the keep policy, the layers after the reduce
layer over the kept tokens, decoding over the kept prefix). It imports
nothing of the program: it works from the raw pixels, the prompt ids and
the HF-layout weights, in natural token order (windows as masks, not as a
permutation), with no kernels, caches or batching. Matrix products run in
float32 with TF32 off; weights are read in their stored dtype and widened
to float32 where they are used.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
NEG = -1e30


def fp32_only() -> None:
    """Matrix products in float32 proper: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [L, heads, D], cos/sin [L, D]."""
    return x * cos[:, None] + rotate_half(x) * sin[:, None]


def vision_cos_sin(hw: torch.Tensor, dim: int, theta: float = 10000.0):
    """2-D rope over (h, w) ids [L, 2]: half the rotary pairs for h, half
    for w."""
    quarter = torch.arange(0, dim // 2, 2, dtype=torch.float32, device=hw.device)
    inv = 1.0 / theta ** (quarter / (dim // 2))
    half = torch.cat([hw[:, 0:1].float() * inv, hw[:, 1:2].float() * inv], -1)
    emb = torch.cat([half, half], -1)
    return emb.cos(), emb.sin()


def mrope_cos_sin(pos: torch.Tensor, dim: int, theta: float, sections: Sequence[int]):
    """3-D mRoPE over position ids [3, L] (t, h, w): the rotary pairs are
    taken section by section from the t, h and w channels."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim)
    freqs = pos.float()[..., None] * inv  # [3, L, dim/2]
    parts, at = [], 0
    for c, n in enumerate(sections):
        parts.append(freqs[c % 3, :, at:at + n])
        at += n
    half = torch.cat(parts, -1)
    emb = torch.cat([half, half], -1)
    return emb.cos(), emb.sin()


def masked_attention(q, k, v, allowed, scale, rows: int = 4096):
    """softmax(q k^T * scale, masked by allowed [Lq, Lk] or None) v, head by
    head and in blocks of query rows. q [Lq, H, Dq], k [Lk, H, Dq], v [Lk,
    H, Dv] -> [Lq, H, Dv]."""
    out = torch.empty(q.shape[0], q.shape[1], v.shape[-1], device=q.device)
    for h in range(q.shape[1]):
        kh, vh = k[:, h], v[:, h]
        for r in range(0, q.shape[0], rows):
            s = (q[r:r + rows, h] @ kh.T) * scale
            if allowed is not None:
                s = s.masked_fill(~allowed[r:r + rows], NEG)
            out[r:r + rows, h] = torch.softmax(s, -1) @ vh
    return out


class Request:
    """One request as both sides receive it: an image [H, W, 3] uint8 and
    prompt ids with one image marker."""

    def __init__(self, image: np.ndarray, prompt: List[int]):
        self.image = image
        self.prompt = list(prompt)


class Reference:
    """The reference over one configuration's ``model`` section and the
    weights of ``gpbench.weights.draw`` (HF layout, GlimpsePrune modules)."""

    def __init__(self, model: dict, hf: Dict[str, torch.Tensor], gp: Dict[str, torch.Tensor],
                 device):
        self.m, self.hf, self.gp, self.dev = model, hf, gp, torch.device(device)
        self.v, self.t, self.g = model["vision"], model["text"], model["gp"]

    def w(self, name: str) -> torch.Tensor:
        src = self.gp if name in self.gp else self.hf
        return src[name].float()

    def lin(self, x, name, bias=True):
        b = name + ".bias"
        has = b in self.hf or b in self.gp
        return F.linear(x, self.w(name + ".weight"), self.w(b) if (bias and has) else None)

    # ---- inputs

    def patches(self, image: np.ndarray):
        """Pixels -> (patch rows [P, C*T*ps*ps] in 2x2-merge raster order,
        patch (h, w) ids [P, 2], merged grid (gh, gw))."""
        v = self.v
        ps, tps, ms = v["patch_size"], v["temporal_patch_size"], v["spatial_merge_size"]
        h, w, c = image.shape
        if h % (ps * ms) or w % (ps * ms):
            raise ValueError(f"a {h}x{w} image is not a multiple of {ps * ms} px")
        x = torch.as_tensor(image, device=self.dev).float() / 255.0
        x = (x - torch.tensor(CLIP_MEAN, device=self.dev)) / torch.tensor(CLIP_STD,
                                                                          device=self.dev)
        frames = x.permute(2, 0, 1)[None].expand(tps, c, h, w)  # [T, C, H, W]
        gh, gw = h // ps, w // ps
        p = frames.reshape(tps, c, gh // ms, ms, ps, gw // ms, ms, ps)
        p = p.permute(2, 5, 3, 6, 1, 0, 4, 7).reshape(gh * gw, c * tps * ps * ps)
        bh, bw, ih, iw = torch.meshgrid(*(torch.arange(n, device=self.dev)
                                          for n in (gh // ms, gw // ms, ms, ms)), indexing="ij")
        hw = torch.stack([(bh * ms + ih).reshape(-1), (bw * ms + iw).reshape(-1)], -1)
        return p, hw, (gh // ms, gw // ms)

    def sequence(self, req: Request, n_img: int):
        """(ids [S], the first glimpse slot) of the prompt with its image
        marker expanded to n_img image tokens and the glimpse slots
        appended."""
        ids = []
        for tok in req.prompt:
            ids += [tok] * n_img if tok == self.m["image_token_id"] else [tok]
        le_len = self.g["le_length"] if self.g["le_layers"] else 0
        le_start = len(ids)
        ids += [self.m["eos_token_id"]] * le_len
        return torch.tensor(ids, device=self.dev), le_start

    def positions(self, ids: torch.Tensor, grid):
        """mRoPE ids [3, S] of a row with one image: text counts on, the
        image's tokens take (0, h, w) offset by the text before them, and
        the text after continues past the image's largest id."""
        gh, gw = grid
        img = ids == self.m["image_token_id"]
        first = int(img.nonzero()[0])
        n = int(img.sum())
        pos = torch.zeros(3, ids.shape[0], dtype=torch.long, device=self.dev)
        pos[:, :first] = torch.arange(first, device=self.dev)
        hh, ww = torch.meshgrid(torch.arange(gh, device=self.dev),
                                torch.arange(gw, device=self.dev), indexing="ij")
        pos[0, first:first + n] = first
        pos[1, first:first + n] = first + hh.reshape(-1)
        pos[2, first:first + n] = first + ww.reshape(-1)
        start = first + max(gh, gw)
        rest = ids.shape[0] - first - n
        pos[:, first + n:] = start + torch.arange(rest, device=self.dev)
        return pos

    # ---- vision

    def vision(self, image: np.ndarray):
        """-> (merged tokens [N, out], taps {block: [N, hidden]}, grid)."""
        v = self.v
        ms, mu = v["spatial_merge_size"], v["spatial_merge_size"] ** 2
        heads, hid = v["num_heads"], v["hidden_size"]
        d = hid // heads
        rows, hw, grid = self.patches(image)
        p = rows.shape[0]
        x = rows @ self.w("visual.patch_embed.proj.weight").reshape(hid, -1).T
        cos, sin = vision_cos_sin(hw, d)
        # windows of win x win merged tokens, as masks over natural order
        win = v["window_size"] // ms // v["patch_size"]
        wid = (hw[:, 0] // ms // win) * 10 ** 6 + (hw[:, 1] // ms // win)
        order = torch.sort(wid, stable=True).indices
        wp = win * win * mu
        taps = {}
        for b in range(v["depth"]):
            pre = f"visual.blocks.{b}"
            h = rms_norm(x, self.w(f"{pre}.norm1.weight"), 1e-6)
            qkv = self.lin(h, f"{pre}.attn.qkv").reshape(p, 3, heads, d)
            q, k, vv = rope(qkv[:, 0], cos, sin), rope(qkv[:, 1], cos, sin), qkv[:, 2]
            if b in v["fullatt_block_indexes"]:
                a = masked_attention(q, k, vv, None, d ** -0.5)
            else:
                qw, kw, vw = (t[order].reshape(p // wp, wp, heads, d).transpose(1, 2)
                              for t in (q, k, vv))
                s = torch.softmax((qw @ kw.transpose(-1, -2)) * d ** -0.5, -1)
                a = torch.empty_like(vv)
                a[order] = (s @ vw).transpose(1, 2).reshape(p, heads, d)
            x = x + self.lin(a.reshape(p, hid), f"{pre}.attn.proj")
            h = rms_norm(x, self.w(f"{pre}.norm2.weight"), 1e-6)
            x = x + self.lin(F.silu(self.lin(h, f"{pre}.mlp.gate_proj"))
                             * self.lin(h, f"{pre}.mlp.up_proj"), f"{pre}.mlp.down_proj")
            if b in self.g["selected_visual_layers"]:
                taps[b] = x.reshape(-1, mu, hid).mean(1)
        m = rms_norm(x, self.w("visual.merger.ln_q.weight"), 1e-6).reshape(-1, mu * hid)
        m = self.lin(F.gelu(self.lin(m, "visual.merger.mlp.0")), "visual.merger.mlp.2")
        return m, taps, grid

    # ---- decoder

    def layer(self, l: int, x, cos, sin, k_prev=None, v_prev=None):
        """Decoder layer l over x [L, H], causal among x's rows, after an
        optional prefix k_prev / v_prev [Lp, Hkv, D] that every row sees.
        -> (x, q, k, v) with q, k, v post-rope (k, v of x's rows only)."""
        t = self.t
        heads, kvh = t["num_attention_heads"], t["num_key_value_heads"]
        d = t["hidden_size"] // heads
        pre = f"model.layers.{l}"
        eps = t["rms_norm_eps"]
        n = x.shape[0]
        h = rms_norm(x, self.w(f"{pre}.input_layernorm.weight"), eps)
        q = rope(self.lin(h, f"{pre}.self_attn.q_proj").reshape(n, heads, d), cos, sin)
        k = rope(self.lin(h, f"{pre}.self_attn.k_proj").reshape(n, kvh, d), cos, sin)
        v = self.lin(h, f"{pre}.self_attn.v_proj").reshape(n, kvh, d)
        kk, vv = k, v
        lp = 0
        if k_prev is not None:
            kk, vv, lp = torch.cat([k_prev, k]), torch.cat([v_prev, v]), k_prev.shape[0]
        allowed = (torch.arange(lp + n, device=x.device)[None, :]
                   <= lp + torch.arange(n, device=x.device)[:, None])
        g = heads // kvh
        a = masked_attention(q, kk.repeat_interleave(g, 1), vv.repeat_interleave(g, 1), allowed,
                             d ** -0.5)
        x = x + self.lin(a.reshape(n, heads * d), f"{pre}.self_attn.o_proj", bias=False)
        h = rms_norm(x, self.w(f"{pre}.post_attention_layernorm.weight"), eps)
        x = x + self.lin(F.silu(self.lin(h, f"{pre}.mlp.gate_proj", bias=False))
                         * self.lin(h, f"{pre}.mlp.up_proj", bias=False),
                         f"{pre}.mlp.down_proj", bias=False)
        return x, q, k, v

    def logits(self, x) -> torch.Tensor:
        t = self.t
        x = rms_norm(x, self.w("model.norm.weight"), t["rms_norm_eps"])
        head = ("model.embed_tokens.weight" if t.get("tie_word_embeddings", False)
                else "lm_head.weight")
        return x @ self.w(head).T

    def le_vectors(self) -> torch.Tensor:
        """The projected glimpse embeddings at every layer [L, le_len, H]."""
        t, g = self.t, self.g
        le = F.linear(self.w("learnable_embeddings"), self.w("le_proj.weight"),
                      self.w("le_proj.bias"))
        le = rms_norm(le, self.w("le_norm.weight"), t["rms_norm_eps"])
        out = torch.zeros(t["num_hidden_layers"], *le.shape[1:], device=le.device)
        out[list(g["le_layers"])] = le
        return out

    # ---- GlimpsePrune

    def fuser(self, attn_map, taps, grid) -> torch.Tensor:
        """AttnFuserV1 at inference: the last layer's keep logits [N]."""
        g = self.g
        heads = g["attn_fuse_num_heads"]
        gh, gw = grid
        hh, ww = torch.meshgrid(torch.arange(gh, device=self.dev),
                                torch.arange(gw, device=self.dev), indexing="ij")
        hw = torch.stack([hh.reshape(-1), ww.reshape(-1)], -1)
        n = hw.shape[0]
        allowed = None
        if not g["attn_fuse_global"]:
            win = self.v["window_size"] // self.v["spatial_merge_size"] // self.v["patch_size"]
            wid = (hw[:, 0] // win) * 10 ** 6 + hw[:, 1] // win
            allowed = wid[:, None] == wid[None, :]
        f = "attn_fuser"
        x = self.lin(attn_map, f"{f}.attn_in_proj")
        qk_dim = (g["attn_fuse_size"] + g["visual_cond_size"]) // heads
        cos, sin = vision_cos_sin(hw, qk_dim)
        layers = list(g["selected_visual_layers"])
        for i, tap_layer in enumerate(layers):
            p = f"{f}.layers.{i}"
            cond = self.lin(taps[tap_layer], f"{f}.cond_in_projs.{i}")
            h = rms_norm(x, self.w(f"{p}.norm1.weight"), 1e-6)
            qk_in = torch.cat([h, cond], -1)
            q = rope(self.lin(qk_in, f"{p}.attn.q_proj", False).reshape(n, heads, -1), cos, sin)
            k = rope(self.lin(qk_in, f"{p}.attn.k_proj", False).reshape(n, heads, -1), cos, sin)
            v = self.lin(h, f"{p}.attn.v_proj", False).reshape(n, heads, -1)
            a = masked_attention(q, k, v, allowed, qk_dim ** -0.5)
            x = x + self.lin(a.reshape(n, -1), f"{p}.attn.o_proj", False)
            h = rms_norm(x, self.w(f"{p}.norm2.weight"), 1e-6)
            x = x + self.lin(F.silu(self.lin(h, f"{p}.mlp.gate_proj"))
                             * self.lin(h, f"{p}.mlp.up_proj"), f"{p}.mlp.down_proj")
        return self.lin(x, f"{f}.attn_out_projs.{len(layers) - 1}")[:, 0]

    def keep_policy(self, logits: torch.Tensor) -> torch.Tensor:
        """The keep set [N] of the recipe from keep logits: above the
        threshold, capped to the top floor(ratio * N), at least the floor."""
        g = self.g
        probs = torch.sigmoid(logits)
        keep = probs > g["reduce_threshold"]
        rank = torch.empty_like(logits, dtype=torch.long)
        rank[torch.sort(-probs, stable=True).indices] = torch.arange(logits.shape[0],
                                                                     device=logits.device)
        if g.get("max_remain_ratio") is not None:
            cap = math.floor(g["max_remain_ratio"] * logits.shape[0])
            if int(keep.sum()) > cap:
                keep = rank < cap
        floor = g.get("min_remain_num")
        if floor is not None and int(keep.sum()) < floor:
            keep = keep | (rank < floor)
        return keep

    def boundary(self, logits: torch.Tensor) -> float:
        """The keep logit at which the recipe's decision turns: midway
        between the last kept and the first dropped where the cap binds,
        the threshold's logit otherwise."""
        g = self.g
        thr = g["reduce_threshold"]
        n_above = int((torch.sigmoid(logits) > thr).sum())
        ratio = g.get("max_remain_ratio")
        if ratio is not None:
            cap = math.floor(ratio * logits.shape[0])
            if n_above > cap and 0 < cap < logits.shape[0]:
                top = torch.sort(logits, descending=True).values
                return float(top[cap - 1] + top[cap]) / 2
        return math.log(thr / (1 - thr))

    @torch.no_grad()
    def glimpse(self, req: Request):
        """ViT, layers 0..reduce_layer with the glimpse embeddings, the
        harvest and the fuser -> a state dict for ``served_logits``, with
        ``keep_logits`` [N]."""
        t, g = self.t, self.g
        heads, kvh = t["num_attention_heads"], t["num_key_value_heads"]
        d = t["hidden_size"] // heads
        merged, taps, grid = self.vision(req.image)
        n_img = merged.shape[0]
        ids, le_start = self.sequence(req, n_img)
        pos = self.positions(ids, grid)
        cos, sin = mrope_cos_sin(pos, d, t["rope_theta"], t["mrope_section"])
        img = (ids == self.m["image_token_id"]).nonzero()[:, 0]
        x = self.hf["model.embed_tokens.weight"][ids].float()
        x[img] = merged
        le_len = self.g["le_length"] if self.g["le_layers"] else 0
        le = self.le_vectors()
        if le_len and 0 in g["le_layers"]:
            x[le_start:le_start + le_len] = le[0]
        red = min(g["reduce_layer"], t["num_hidden_layers"] - 1)
        ks, vs, harvest = [], [], []
        for l in range(red + 1):
            if le_len and l > 0:
                x[le_start:le_start + le_len] = x[le_start:le_start + le_len] + le[l]
            x, q, k, v = self.layer(l, x, cos, sin)
            ks.append(k)
            vs.append(v)
            if l in g["selected_layers"]:
                qi = le_start + le_len - 1 if le_len else ids.shape[0] - 1
                raw = torch.einsum("hd,shd->sh", q[qi], k.repeat_interleave(heads // kvh, 1))
                raw = raw * d ** -0.5
                harvest.append(raw if g["use_attention_logits"] else torch.log_softmax(raw, 0))
        attn_map = torch.stack(harvest, 1).reshape(ids.shape[0], -1)[img]
        keep_logits = self.fuser(attn_map, taps, grid)
        return dict(ids=ids, pos=pos, x=x, ks=ks, vs=vs, img=img, le_start=le_start,
                    le_len=le_len, keep_logits=keep_logits, red=red)

    @torch.no_grad()
    def served_logits(self, st: dict, keep_img: torch.Tensor, served: Sequence[int]):
        """Logits [T, V] that predict each served token, for a decode that
        keeps the image tokens ``keep_img`` [N] (bool): the first from the
        prefill's last kept position, the others after feeding the served
        tokens before them."""
        t = self.t
        heads = t["num_attention_heads"]
        d = t["hidden_size"] // heads
        s = st["ids"].shape[0]
        keep = torch.ones(s, dtype=torch.bool, device=self.dev)
        keep[st["le_start"]:st["le_start"] + st["le_len"]] = False
        keep[st["img"]] = keep_img.to(self.dev)
        kept = keep.nonzero()[:, 0]
        pos = st["pos"][:, kept]
        cos, sin = mrope_cos_sin(pos, d, t["rope_theta"], t["mrope_section"])
        pk = [k[kept] for k in st["ks"]]
        pv = [v[kept] for v in st["vs"]]
        x = st["x"][kept]
        for l in range(st["red"] + 1, t["num_hidden_layers"]):
            x, _, k, v = self.layer(l, x, cos, sin)
            pk.append(k)
            pv.append(v)
        first = self.logits(x[-1:])
        served = torch.as_tensor(list(served), device=self.dev)
        if served.shape[0] < 2:
            return first
        last = pos[:, -1]
        npos = last[:, None] + 1 + torch.arange(served.shape[0] - 1, device=self.dev)
        cos, sin = mrope_cos_sin(npos, d, t["rope_theta"], t["mrope_section"])
        y = self.hf["model.embed_tokens.weight"][served[:-1]].float()
        for l in range(t["num_hidden_layers"]):
            y, _, _, _ = self.layer(l, y, cos, sin, pk[l], pv[l])
        return torch.cat([first, self.logits(y)])

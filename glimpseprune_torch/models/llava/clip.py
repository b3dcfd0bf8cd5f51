"""CLIP ViT-L vision tower (LLaVA-1.5's frozen encoder) with feature taps,
and CDPruner's CLIP text tower.

Counterpart of glimpseprune_tpu/models/llava/clip.py (``CLIPAttention``
:24, ``CLIPMLP`` :59, ``CLIPBlock`` :73, ``CLIPTextBlock`` :101,
``CLIPTextTower`` :124, ``CLIPVisionTower`` :171), with the same arithmetic:
the attention logits in fp32 from the q and k of the model dtype, the
probabilities rounded to v's dtype before P V (:40, :46), quick-GELU in the
MLPs, LayerNorm with eps 1e-5 over fp32 parameters. The attention is plain
PyTorch (matmul, softmax, matmul), as the JAX package's is an XLA einsum:
no Pallas kernel exists for it. The patch embedding is a convolution over
NCHW pixels with HF's [out, in, kh, kw] weight. Module and parameter names
follow the Flax names (``layers.{i}`` for ``layers_{i}``), which are HF's,
so both weight bridges map them one to one.

The tower returns the patch features (CLS dropped) of ``feature_layer``
and the taps at ``tap_layers``; it runs the blocks up to the deepest of
those, since the JAX tower's later blocks change neither output.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from glimpseprune_torch.models.layers import ACT2FN, LayerNorm, Linear

NEG_INF = -1e30
LN_EPS = 1e-5


class FP32LayerNorm(LayerNorm):
    """flax ``nn.LayerNorm(epsilon=1e-5, param_dtype=float32)``: the scale
    and bias stay fp32 when the model is cast to another dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, LN_EPS)

    def _apply(self, fn, recurse=True):
        kept = {n: p.data for n, p in self._parameters.items() if p is not None}
        super()._apply(fn, recurse)
        for n, t in kept.items():  # follow the device, keep the fp32 values
            p = self._parameters[n]
            if p.dtype != torch.float32:
                p.data = t.to(device=p.device, dtype=torch.float32)
        return self


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(hidden_size, hidden_size)
        self.k_proj = Linear(hidden_size, hidden_size)
        self.v_proj = Linear(hidden_size, hidden_size)
        self.out_proj = Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, causal: bool = False,
                key_valid: Optional[torch.Tensor] = None, emit_importance: bool = False):
        """x [B, S, D] -> [B, S, D]; key_valid [B, S] masks keys. With
        emit_importance also (the CLS query's attention over the patches,
        head-mean [B, S - 1] fp32; the patch keys, head-mean [B, S - 1, hd]
        fp32), VisionZip's and VScan's scores (JAX :48-56)."""
        b, s, d = x.shape
        hd = d // self.num_heads
        q, k, v = (proj(x).reshape(b, s, self.num_heads, hd).transpose(1, 2)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        logits = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
        if causal:
            allowed = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~allowed, NEG_INF)
        if key_valid is not None:
            logits = logits.masked_fill(~key_valid[:, None, None, :], NEG_INF)
        probs = torch.softmax(logits, -1).to(v.dtype)
        out = self.out_proj((probs @ v).transpose(1, 2).reshape(b, s, d))
        if emit_importance:
            return out, (probs[:, :, 0, 1:].float().mean(1), k[:, :, 1:].float().mean(1))
        return out


class CLIPMLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int):
        super().__init__()
        self.fc1 = Linear(hidden_size, intermediate_size)
        self.fc2 = Linear(intermediate_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(ACT2FN["quick_gelu"](self.fc1(x)))


class CLIPBlock(nn.Module):
    """Pre-norm block; ``causal`` and ``key_valid`` make it the text
    tower's (JAX ``CLIPTextBlock``)."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int):
        super().__init__()
        self.layer_norm1 = FP32LayerNorm(hidden_size)
        self.self_attn = CLIPAttention(hidden_size, num_heads)
        self.layer_norm2 = FP32LayerNorm(hidden_size)
        self.mlp = CLIPMLP(hidden_size, intermediate_size)

    def forward(self, x, causal: bool = False, key_valid=None, emit_importance: bool = False):
        attn = self.self_attn(self.layer_norm1(x), causal, key_valid, emit_importance)
        importance = None
        if emit_importance:
            attn, importance = attn
        x = x + attn
        x = x + self.mlp(self.layer_norm2(x))
        return (x, importance) if emit_importance else x


class CLIPVisionTower(nn.Module):
    """pixels [B, H, W, C] normalized -> (patch features [B, G*G, D] of
    ``feature_layer``, taps [B, G*G, D] per tap layer). ``clip_cfg`` is the
    family's ``CLIPTowerConfig``; with its ``with_text_tower`` the tower
    also holds ``post_layernorm`` and ``visual_projection``, CDPruner's
    image-text embedding space (JAX :236-246)."""

    def __init__(self, clip_cfg, tap_layers: Sequence[int] = ()):
        super().__init__()
        cc = self.clip_cfg = clip_cfg
        self.tap_layers = tuple(tap_layers)
        g = cc.grid
        self.patch_embedding = nn.Conv2d(3, cc.hidden_size, cc.patch_size, cc.patch_size,
                                         bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cc.hidden_size))
        self.position_embedding = nn.Parameter(torch.zeros(g * g + 1, cc.hidden_size))
        self.pre_layrnorm = FP32LayerNorm(cc.hidden_size)
        self.layers = nn.ModuleList(
            CLIPBlock(cc.hidden_size, cc.num_heads, cc.intermediate_size)
            for _ in range(cc.depth))
        if cc.with_text_tower:
            self.post_layernorm = FP32LayerNorm(cc.hidden_size)
            self.visual_projection = Linear(cc.hidden_size, cc.projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor, emit_importance: bool = False,
                emit_embeds: bool = False):
        """-> (features, taps[, importance][, embeds]): importance the
        (CLS attention [B, N], keys [B, N, hd]) of the feature layer,
        embeds [B, N, projection_dim] the projected features."""
        cc = self.clip_cfg
        b = pixels.shape[0]
        dtype = self.patch_embedding.weight.dtype
        x = self.patch_embedding(pixels.to(dtype).permute(0, 3, 1, 2))  # [B, D, G, G]
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], 1) + self.position_embedding.to(dtype)
        x = self.pre_layrnorm(x)
        feature_layer = cc.feature_layer % cc.depth
        taps: List[Optional[torch.Tensor]] = [None] * len(self.tap_layers)
        features = importance = None
        for i in range(max((feature_layer,) + self.tap_layers) + 1):
            want_imp = emit_importance and i == feature_layer
            x = self.layers[i](x, emit_importance=want_imp)
            if want_imp:
                x, importance = x
            if i == feature_layer:
                features = x[:, 1:]
            if i in self.tap_layers:
                taps[self.tap_layers.index(i)] = x[:, 1:]
        out = (features, taps)
        if emit_importance:
            out += (importance,)
        if emit_embeds:
            out += (self.visual_projection(self.post_layernorm(features)),)
        return out


class CLIPTextTower(nn.Module):
    """CLIPTextModelWithProjection (JAX :124-168): text_ids [M, S]
    zero-padded segments -> projected pooled embeds [M, projection_dim],
    pooled at the EOT token (the largest id, HF's convention)."""

    def __init__(self, clip_cfg):
        super().__init__()
        cc = clip_cfg
        h = cc.text_hidden_size
        self.token_embedding = nn.Embedding(cc.text_vocab_size, h)
        self.position_embedding = nn.Parameter(torch.zeros(cc.text_max_positions, h))
        self.layers = nn.ModuleList(
            CLIPBlock(h, cc.text_num_heads, cc.text_intermediate_size)
            for _ in range(cc.text_depth))
        self.final_layer_norm = FP32LayerNorm(h)
        self.text_projection = Linear(h, cc.projection_dim, bias=False)

    def forward(self, text_ids: torch.Tensor,
                text_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = text_ids.shape[1]
        x = self.token_embedding(text_ids)
        x = x + self.position_embedding[:s].to(x.dtype)
        for layer in self.layers:
            x = layer(x, causal=True, key_valid=text_valid)
        x = self.final_layer_norm(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), text_ids.argmax(-1)]
        return self.text_projection(pooled)


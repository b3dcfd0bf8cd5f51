"""Qwen2.5 text decoder: prefill with glimpse-embedding injection and the
glimpse harvest, decode against a KV cache, final norm and LM head.

Counterpart of glimpseprune_tpu/models/qwen2_5_vl/language.py
(``TextDecoder`` :238, ``_layer_prefill`` :113, ``_layer_decode`` :135,
``harvest_postprocess`` :169, ``run_layers`` :393). The JAX package scans
one stacked parameter tree; here the layers are a ModuleList run by a
Python loop, and a layer range is a slice of that loop.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from glimpseprune_tpu.config import TextConfig
from glimpseprune_torch.models.layers import GatedMLP, RMSNorm
from glimpseprune_torch.ops.attention import causal_segment_attention, decode_attention
from glimpseprune_torch.ops.kv_cache import cache_append, cache_layer
from glimpseprune_torch.ops.rope import apply_rotary


class SelfAttention(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        dq = cfg.num_attention_heads * cfg.head_dim
        dkv = cfg.num_key_value_heads * cfg.head_dim
        self.q_proj = nn.Linear(cfg.hidden_size, dq, bias=cfg.attention_bias)
        self.k_proj = nn.Linear(cfg.hidden_size, dkv, bias=cfg.attention_bias)
        self.v_proj = nn.Linear(cfg.hidden_size, dkv, bias=cfg.attention_bias)
        self.o_proj = nn.Linear(dq, cfg.hidden_size, bias=False)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = SelfAttention(cfg)
        self.mlp = GatedMLP(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act)

    def qkv(self, x, cos, sin):
        c = self.cfg
        b, s, _ = x.shape
        h = self.input_layernorm(x)
        a = self.self_attn
        q = a.q_proj(h).reshape(b, s, c.num_attention_heads, c.head_dim)
        k = a.k_proj(h).reshape(b, s, c.num_key_value_heads, c.head_dim)
        v = a.v_proj(h).reshape(b, s, c.num_key_value_heads, c.head_dim)
        return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v

    def finish(self, x, attn):
        """Output projection, residual, MLP block."""
        b, s = x.shape[:2]
        x = x + self.self_attn.o_proj(attn.reshape(b, s, -1))
        return x + self.mlp(self.post_attention_layernorm(x))

    def prefill(self, x, cos, sin, valid, q_index):
        """-> (x, k, v, sel_q): sel_q is the glimpse query's post-rope q
        [B, Hq, D] at q_index, the only per-layer harvest state."""
        q, k, v = self.qkv(x, cos, sin)
        x = self.finish(x, causal_segment_attention(q, k, v, valid))
        sel_q = q[torch.arange(q.shape[0], device=q.device), q_index]
        return x, k, v, sel_q

    def decode(self, layer: int, x, cos, sin, k_cache, v_cache, kv_valid, write_idx: int):
        """One decode layer against the stacked cache [L, B, T, Hkv, D]:
        the layer's slice is read, then the new tokens' k/v are written in
        place at write_idx."""
        q, k, v = self.qkv(x, cos, sin)
        attn = decode_attention(q, cache_layer(k_cache, layer), cache_layer(v_cache, layer),
                                kv_valid, k, v, write_idx)
        cache_append(k_cache, k, layer, write_idx)
        cache_append(v_cache, v, layer, write_idx)
        return self.finish(x, attn)


def harvest_postprocess(raw_row: torch.Tensor, valid: torch.Tensor,
                        use_attention_logits: bool) -> torch.Tensor:
    """raw_row [B, S, Hq] scaled q @ K^T logits of the glimpse query ->
    the raw logits, or their log-softmax over S masked by the pad mask only
    (reference semantics; see the JAX docstring at language.py:169)."""
    if use_attention_logits:
        return raw_row
    logits = raw_row.masked_fill(~valid[..., None], -float("inf"))
    return torch.log_softmax(logits, dim=1)


class TextDecoder(nn.Module):
    """Embedding + decoder layers + final norm + LM head."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_word_embeddings:  # flax nn.Embed.attend
            return F.linear(x, self.embed_tokens.weight)
        return self.lm_head(x)

    def run_layers(
        self,
        x: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        valid: torch.Tensor,
        layer_start: int = 0,
        layer_end: Optional[int] = None,
        le_vecs: Optional[torch.Tensor] = None,    # [L_total, le_len, H] projected
        le_offset: Optional[torch.Tensor] = None,  # [B, S] clipped index into le_len
        le_inside: Optional[torch.Tensor] = None,  # [B, S] bool
        harvest_layers: Sequence[int] = (),
        q_index: Optional[torch.Tensor] = None,
        use_attention_logits: bool = False,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor], Dict[int, torch.Tensor]]:
        """Run layers [layer_start, layer_end] (inclusive).

        le_vecs, when given, are added at each layer's entry at the glimpse
        slots (le_inside), except at layer 0, whose glimpse splice happened
        at the embedding. Returns (x, (kv_k, kv_v) each
        [n, B, S, Hkv, D], {layer: [B, S, Hq] harvested rows})."""
        cfg = self.cfg
        if layer_end is None:
            layer_end = cfg.num_hidden_layers - 1
        b, s, _ = x.shape
        if q_index is None:
            q_index = torch.full((b,), s - 1, dtype=torch.long, device=x.device)
        ks, vs, sel_qs = [], [], {}
        for lid in range(layer_start, layer_end + 1):
            if le_vecs is not None and lid > 0:
                le_rows = le_vecs[lid][le_offset]
                x = x + torch.where(le_inside[..., None], le_rows.to(x.dtype),
                                    torch.zeros((), dtype=x.dtype, device=x.device))
            x, k, v, sel_q = self.layers[lid].prefill(x, cos, sin, valid, q_index)
            ks.append(k)
            vs.append(v)
            if lid in harvest_layers:
                sel_qs[lid] = sel_q
        harvests = {}
        g = cfg.num_attention_heads // cfg.num_key_value_heads
        for lid in harvest_layers:
            k_exp = ks[lid - layer_start].float().repeat_interleave(g, dim=2)  # [B, S, Hq, D]
            raw = torch.einsum("bhd,bthd->bth", sel_qs[lid].float(), k_exp)
            raw = raw / cfg.head_dim ** 0.5
            harvests[lid] = harvest_postprocess(raw, valid, use_attention_logits)
        return x, (torch.stack(ks), torch.stack(vs)), harvests

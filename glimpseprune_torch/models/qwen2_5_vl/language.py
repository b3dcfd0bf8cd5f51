"""Qwen2.5 text decoder: prefill with glimpse-embedding injection and the
glimpse harvest, decode against a KV cache, final norm and LM head.

Counterpart of glimpseprune_tpu/models/qwen2_5_vl/language.py
(``TextDecoder`` :238, ``_layer_prefill`` :113, ``_layer_decode`` :135,
``harvest_postprocess`` :169, ``chunked_nll`` :293,
``chunked_token_logprobs`` :364, ``run_layers`` :393 with the multi-query
harvest of ``harvest_q_start``, ``decode_step`` :500, with
``inputs_embeds``, ``logits_index`` and ``new_valid`` for chunked prefill).
The in-layer LoRA of ``lora_rank > 0`` lives in the projections
(models/layers.py).
The JAX package scans one stacked parameter tree; here the layers are a
ModuleList run by a Python loop, and a layer range is a slice of that loop.
``cfg.remat`` (the JAX ``jax.checkpoint`` of the scan body, :462) becomes
``torch.utils.checkpoint`` around each layer while autograd records.
The quantized tiers follow the JAX package: W8A8 (``a8``) in the prefill
layers, in decode only under ``act_quant="int8"`` (``_act_quant_on`` :85),
int8 flash attention in prefill when the tower's flags ask for it
(:122-127), and the head's a8 only under ``"int8"`` (:290).

Under sequence parallelism (parallel/sequence.py) ``run_layers`` shards the
sequence over the group when it divides (``sp_split``, read at each call):
x, the rope tables and the padding mask are split, each layer attends with
its local queries over the gathered K/V (K9), and x is gathered again after
the last layer. The gathered per-layer K/V are what ``collect_kv`` returns,
the replicated cache that decode reads unsharded, as in JAX. The glimpse
embeddings are added on the whole sequence and split like x, so their
gradient is whole on every rank; the harvest takes the glimpse query from
the rank that holds it by a collective over [B, Hq, D] and gathers the
harvested rows.

Under tensor parallelism (parallel/mesh.py ``shard_params``) each layer's
projections hold this rank's heads and intermediate columns (the layers
run their collectives), so attention and the cache see the local heads
(``kv_heads``); the harvested rows are all-gathered along the heads. The
embedding and the head are vocab-parallel (``vocab_tp``): a masked lookup
of the local vocab rows summed over the ranks, and the local logits
all-gathered along the vocab.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from glimpseprune_torch.config import TextConfig
from glimpseprune_torch.models.layers import GatedMLP, Linear, RMSNorm
from glimpseprune_torch.ops.attention import causal_segment_attention, decode_attention
from glimpseprune_torch.ops.kv_cache import cache_append, cache_layer
from glimpseprune_torch.ops.rope import apply_rotary
from glimpseprune_torch.parallel.sequence import (
    SeqShard,
    copy_to_model,
    gather_kv,
    gather_seq,
    reduce_from_model,
    sp_split,
    split_seq,
)


def _act_quant_on(cfg: TextConfig, decoding: bool) -> bool:
    """W8A8 where the products are compute-bound: everywhere under "int8",
    in the prefill layers only under "prefill" (decode reads weights)."""
    if cfg.act_quant == "int8":
        return True
    return cfg.act_quant == "prefill" and not decoding


class SelfAttention(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        dq = cfg.num_attention_heads * cfg.head_dim
        dkv = cfg.num_key_value_heads * cfg.head_dim
        self.q_proj = Linear(cfg.hidden_size, dq, bias=cfg.attention_bias)
        self.k_proj = Linear(cfg.hidden_size, dkv, bias=cfg.attention_bias)
        self.v_proj = Linear(cfg.hidden_size, dkv, bias=cfg.attention_bias)
        self.o_proj = Linear(dq, cfg.hidden_size, bias=False)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = SelfAttention(cfg)
        self.mlp = GatedMLP(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act)

    def qkv(self, x, cos, sin, a8: bool = False):
        c = self.cfg
        b, s, _ = x.shape
        h = self.input_layernorm(x)
        a = self.self_attn
        # the local heads under tensor parallelism
        q = a.q_proj(h, a8).reshape(b, s, -1, c.head_dim)
        k = a.k_proj(h, a8).reshape(b, s, -1, c.head_dim)
        v = a.v_proj(h, a8).reshape(b, s, -1, c.head_dim)
        return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v

    def finish(self, x, attn, a8: bool = False):
        """Output projection, residual, MLP block."""
        b, s = x.shape[:2]
        x = x + self.self_attn.o_proj(attn.reshape(b, s, -1), a8)
        return x + self.mlp(self.post_attention_layernorm(x), a8)

    def prefill(self, x, cos, sin, valid, sp: Optional[SeqShard] = None):
        """-> (x, q, k, v): q is the post-rope q of x's rows (the harvest
        reads the glimpse query from it); k and v are the whole sequence's,
        gathered over the ranks under ``sp``, where x, cos, sin and valid
        are this rank's shard."""
        c = self.cfg
        a8 = _act_quant_on(c, decoding=False)
        q, k, v = self.qkv(x, cos, sin, a8)
        attn, k, v = causal_segment_attention(q, k, v, valid, int8_qk=a8 and c.attn_qk_int8,
                                              int8_pv=a8 and c.attn_pv_int8, sp=sp)
        return self.finish(x, attn, a8), q, k, v

    def decode(self, layer: int, x, cos, sin, k_cache, v_cache, kv_valid,
               write_idx: Union[int, torch.Tensor], new_valid: Optional[torch.Tensor] = None):
        """One decode layer against the stacked cache [L, B, T, Hkv, D]
        (either tier of ops/kv_cache.py; JAX ``_layer_decode`` :135-160):
        the layer's slice is read, then the new tokens' k/v are written in
        place at write_idx (a 0-d tensor on the device in a captured decode
        step, or an int). new_valid [B, S_new] masks the new tokens' own
        keys (a prefill chunk's left pads)."""
        a8 = _act_quant_on(self.cfg, decoding=True)
        q, k, v = self.qkv(x, cos, sin, a8)
        attn = decode_attention(q, cache_layer(k_cache, layer), cache_layer(v_cache, layer),
                                kv_valid, k, v, write_idx, new_valid)
        cache_append(k_cache, k, layer, write_idx)
        cache_append(v_cache, v, layer, write_idx)
        return self.finish(x, attn, a8)


def harvest_postprocess(raw_row: torch.Tensor, valid: torch.Tensor,
                        use_attention_logits: bool) -> torch.Tensor:
    """raw_row [B, S, Hq] scaled q @ K^T logits of the glimpse query ->
    the raw logits, or their log-softmax over S masked by the pad mask only
    (reference semantics; see the JAX docstring at language.py:169)."""
    if use_attention_logits:
        return raw_row
    logits = raw_row.masked_fill(~valid[..., None], -float("inf"))
    return torch.log_softmax(logits, dim=1)


def _glimpse_query(q: torch.Tensor, q_index: torch.Tensor,
                  sp: Optional[SeqShard] = None) -> torch.Tensor:
    """The post-rope q [B, Hq, D] of each row at q_index, from q [B, S, Hq, D]
    (this rank's shard under ``sp``: the rank holding a row's glimpse slot
    contributes it, the others zeros, summed over the ranks with
    ``gather_kv``, whose backward sums the ranks' gradients as the sharded
    harvest needs)."""
    bidx = torch.arange(q.shape[0], device=q.device)
    if sp is None:
        return q[bidx, q_index]
    sl = q.shape[1]
    local = q_index - sp.rank * sl
    inside = (local >= 0) & (local < sl)
    rows = q[bidx, local.clamp(0, sl - 1)]
    rows = torch.where(inside[:, None, None], rows, torch.zeros((), dtype=q.dtype,
                                                                 device=q.device))
    return gather_kv(rows[:, None], 1, sp).sum(1)


class TextDecoder(nn.Module):
    """Embedding + decoder layers + final norm + LM head."""

    attn_tp: Optional[SeqShard] = None   # the model axis where the heads are sharded
    vocab_tp: Optional[SeqShard] = None  # the model axis where the vocab is sharded

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    @property
    def kv_heads(self) -> int:
        """The kv heads this rank's layers hold (its decode cache's)."""
        tp = self.attn_tp
        return self.cfg.num_key_value_heads // (1 if tp is None else tp.world)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        tp = self.vocab_tp
        if tp is None:
            return self.embed_tokens(input_ids)
        w = self.embed_tokens.weight
        local = input_ids - tp.rank * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        rows = F.embedding(local.clamp(0, w.shape[0] - 1), w)
        rows = rows.masked_fill(~inside[..., None], 0)
        return reduce_from_model(rows, tp)

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.vocab_tp
        if self.cfg.tie_word_embeddings:  # flax nn.Embed.attend
            y = F.linear(x if tp is None else copy_to_model(x, tp), self.embed_tokens.weight)
        else:
            y = self.lm_head(x, self.cfg.act_quant == "int8")
        return y if tp is None else gather_seq(y, -1, tp)

    def _chunk_nll_sum(self, xc: torch.Tensor, yc: torch.Tensor) -> torch.Tensor:
        """Sum of -log p(yc) over the labelled positions of one chunk."""
        lg = self.logits(xc).float()
        lse = torch.logsumexp(lg, dim=-1)
        m = yc != -100
        tgt = torch.gather(lg, -1, torch.where(m, yc, 0)[..., None])[..., 0]
        return ((lse - tgt) * m).sum()

    def chunked_nll(self, x: torch.Tensor, labels: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
        """Shifted next-token mean NLL without materializing [B, S, V] logits.

        x [B, S, H] after the final norm, labels [B, S] with -100 where
        unlabelled. The head, log-sum-exp and label gather run per chunk of
        C positions, each under ``torch.utils.checkpoint`` while autograd
        records, so the peak is one [B, C, V] fp32 chunk, recomputed in the
        backward (the JAX package's scan of ``jax.checkpoint``-ed chunks).
        Equal to log_softmax + one-hot over the whole sequence (token mean,
        ignore index -100)."""
        xs, ys = x[:, :-1], labels[:, 1:].long()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for start in range(0, xs.shape[1], chunk):
            xc, yc = xs[:, start:start + chunk], ys[:, start:start + chunk]
            if torch.is_grad_enabled():
                total = total + checkpoint(self._chunk_nll_sum, xc, yc, use_reentrant=False)
            else:
                total = total + self._chunk_nll_sum(xc, yc)
        return total / (ys != -100).sum().clamp(min=1).float()

    def _chunk_token_logprobs(self, xc: torch.Tensor, yc: torch.Tensor) -> torch.Tensor:
        lg = self.logits(xc).float()
        return torch.gather(lg, -1, yc[..., None])[..., 0] - torch.logsumexp(lg, dim=-1)

    def chunked_token_logprobs(self, x: torch.Tensor, tokens: torch.Tensor,
                               chunk: int = 512) -> torch.Tensor:
        """x [B, T, H] after the final norm and token ids [B, T] -> log
        p(token) [B, T] fp32, the head and its log-sum-exp run per chunk of
        C positions (under ``torch.utils.checkpoint`` while autograd
        records), so no [B, T, V] logits are kept (``chunked_nll``'s memory
        argument, for the GRPO policy and reference forwards)."""
        tokens = tokens.long()
        out = []
        for start in range(0, x.shape[1], chunk):
            xc, yc = x[:, start:start + chunk], tokens[:, start:start + chunk]
            if torch.is_grad_enabled():
                out.append(checkpoint(self._chunk_token_logprobs, xc, yc, use_reentrant=False))
            else:
                out.append(self._chunk_token_logprobs(xc, yc))
        return torch.cat(out, 1)

    def decode_step(self, input_ids: Optional[torch.Tensor], cos: torch.Tensor,
                    sin: torch.Tensor, k_cache, v_cache, kv_valid: torch.Tensor,
                    write_idx: Union[int, torch.Tensor],
                    inputs_embeds: Optional[torch.Tensor] = None,
                    logits_index: Union[int, torch.Tensor, None] = None,
                    new_valid: Optional[torch.Tensor] = None):
        """S_new >= 1 new tokens against the cache [L, B, T, Hkv, D] (JAX
        :500-550): the decode step (S_new = 1) and a chunked-prefill step
        (S_new = C). The tokens are input_ids [B, S_new] or, for a chunk
        with image rows scattered in, inputs_embeds [B, S_new, H]; kv_valid
        [B, T] includes the new slots, which start at write_idx; the new
        tokens attend causally among themselves, new_valid [B, S_new]
        masking those that are pads. Every layer reads its cache slice,
        then writes the new k/v into it in place. logits_index (an int or a
        0-d tensor on the device) runs the head on that one slot only, so a
        chunk never pays a [B, C, V] head.
        Returns (logits [B, S_new or 1, V], k_cache, v_cache)."""
        x = self.embed(input_ids) if inputs_embeds is None else inputs_embeds
        for lid, layer in enumerate(self.layers):
            x = layer.decode(lid, x, cos, sin, k_cache, v_cache, kv_valid, write_idx,
                             new_valid)
        if logits_index is not None:
            x = x.index_select(1, torch.as_tensor(logits_index, device=x.device).reshape(1))
        return self.logits(self.final_norm(x)), k_cache, v_cache

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
        collect_kv: bool = True,
        harvest_q_start: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]],
               Dict[int, torch.Tensor]]:
        """Run layers [layer_start, layer_end] (inclusive).

        le_vecs, when given, are added at each layer's entry at the glimpse
        slots (le_inside), except at layer 0, whose glimpse splice happened
        at the embedding. Returns (x, (kv_k, kv_v) each [n, B, S, Hkv, D],
        or None unless collect_kv, {layer: [B, S, Hq] harvested rows}). With
        ``cfg.remat`` and autograd recording, each layer runs under
        ``torch.utils.checkpoint``: its activations are recomputed in the
        backward instead of kept for the whole depth. Under sequence
        parallelism the layers run on this rank's shard when S divides
        (``sp_split``); every input and output is still the whole
        sequence.

        ``harvest_q_start`` switches the harvest to the multi-query rows of
        the reference's Sep model (JAX :431-448): {layer: [B, S - q_start,
        S, Hq]}, the softmax over the keys, causal and pad masked, of every
        query from q_start on, computed in plain torch from the layer's q
        and k (visualization-scale work, not under sequence parallelism)."""
        cfg = self.cfg
        if layer_end is None:
            layer_end = cfg.num_hidden_layers - 1
        b, s, _ = x.shape
        if q_index is None:
            q_index = torch.full((b,), s - 1, dtype=torch.long, device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        sp = sp_split(s)
        if sp is not None and harvest_q_start is not None:
            raise ValueError("the multi-query harvest does not run under sequence parallelism")
        valid_all = valid
        if sp is not None:
            rows = sp.slice(s)
            x = split_seq(x, 1, sp)
            cos, sin, valid = cos[:, rows], sin[:, rows], valid[:, rows]
        g = cfg.num_attention_heads // cfg.num_key_value_heads
        ks, vs, harvests = [], [], {}
        for lid in range(layer_start, layer_end + 1):
            if le_vecs is not None and lid > 0:
                le_rows = torch.where(le_inside[..., None], le_vecs[lid][le_offset].to(x.dtype),
                                      torch.zeros((), dtype=x.dtype, device=x.device))
                x = x + (le_rows if sp is None else split_seq(le_rows, 1, sp))
            layer = self.layers[lid]
            if remat:
                x, q, k, v = checkpoint(layer.prefill, x, cos, sin, valid, sp,
                                        use_reentrant=False)
            else:
                x, q, k, v = layer.prefill(x, cos, sin, valid, sp)
            if collect_kv:
                ks.append(k)
                vs.append(v)
            if lid in harvest_layers and harvest_q_start is not None:
                k_exp = k.float().repeat_interleave(g, dim=2)  # [B, S, Hq, D]
                raw = torch.einsum("bqhd,bthd->bqht", q[:, harvest_q_start:].float(), k_exp)
                raw = raw / cfg.head_dim ** 0.5
                qpos = harvest_q_start + torch.arange(raw.shape[1], device=x.device)
                keys = torch.arange(s, device=x.device)
                allowed = (keys[None, None, :] <= qpos[None, :, None]) & valid[:, None, :]
                raw = raw.masked_fill(~allowed[:, :, None, :], -float("inf"))
                probs = torch.softmax(raw, dim=-1).permute(0, 1, 3, 2)
                harvests[lid] = (probs if self.attn_tp is None
                                 else gather_seq(probs, 3, self.attn_tp))
            elif lid in harvest_layers:
                sel_q = _glimpse_query(q, q_index, sp)
                k_local = k if sp is None else k[:, rows]
                k_exp = k_local.float().repeat_interleave(g, dim=2)  # [B, S, Hq, D]
                raw = torch.einsum("bhd,bthd->bth", sel_q.float(), k_exp)
                raw = raw / cfg.head_dim ** 0.5
                if sp is not None:
                    raw = gather_seq(raw, 1, sp)
                if self.attn_tp is not None:
                    raw = gather_seq(raw, 2, self.attn_tp)
                harvests[lid] = harvest_postprocess(raw, valid_all, use_attention_logits)
        if sp is not None:
            x = gather_seq(x, 1, sp)
        kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
        return x, kv, harvests

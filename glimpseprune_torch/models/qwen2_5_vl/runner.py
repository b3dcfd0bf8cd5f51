"""The user-facing runner: pruned and unpruned generation, streaming, and
the baseline compressors.

Counterpart of glimpseprune_tpu/models/qwen2_5_vl/runner.py
(``GlimpsePruneRunner.__init__`` / ``glimpse`` / ``generate`` :437-936, with
``use_ref_masks``; the delayed selection ``glimpse_delayed`` /
``apply_selection`` :777-836; the visualization harvest ``harvest_rows``
:707; ``vanilla_prefill_chunked`` / ``vanilla_prefill_chunked_steps`` /
``_chunked_prefill_gen`` :938-1051, ``_decode_loop`` / ``_run_decode`` /
``_trim_eos`` / ``_first_stop_match`` :1053-1190, ``stream_generate``
:1192 and ``generate_compressed`` :1243 with the bodies of
``_staged_impl`` :525 and ``_pre_llm_compress_impl`` :542).
``glimpse``, ``generate`` and ``generate_compressed`` carry JAX's
profiling decorators (:836-847, :1242; utils/profiling.py), which call
straight through unless a ``LoggerControl`` turns them on.

Decode: the JAX package runs a chunk of steps as one jitted ``lax.scan``
(``gp_model.decode_chunk``); here a chunk is n replays of one captured
decode step on a CUDA model (decode_graph.py), the step run eagerly on a
CPU model, and the host reads the tokens and the done flags once per chunk
to stop early (eos, stop sequences). The state of a decode is static: the
runner writes the prefill's KV into a cache it owns for the step's key (B,
T, cache tier, greedy or sampled), or, with ``prealloc_t``, decodes in the
caller's cache, which already holds the prefix (serving assembly:
``ops/kv_cache.cache_fill_rows``). Sampling (``temperature > 0``) draws
from ``rng``, a torch.Generator on the model's device.

Both model families run through this runner: a Qwen2_5_VL_GP with the
Qwen prep (inputs.py), a Llava_GP with the LLaVA prep (models/llava/),
whose vision side alone differs (JAX :444).

The runner's config must be the model's, as the JAX runner builds its
model from its config: the model is bound to a config once (built from it,
or ``quantize_model(..., cfg=...)`` / ``Qwen2_5_VL_GP.set_config``), and
the runner refuses a model bound to a config that differs from its own in
a knob the model reads. The quantized serving tiers ride on both: the
model's Linears are swapped for QuantLinears (``quantization.quantize_model``)
in the config's ``weight_quant`` tier, the config's ``act_quant`` and
attention flags select W8A8 and int8 attention, and under
``kv_cache_quant="int8"`` the decode cache is int8, the prefill's KV
quantized once as it is written (JAX ``_build_decode_cache`` :424, used at
:1134-1137). The runner refuses a config knob that the port does not
implement, and a model whose weights are not in the config's tier, rather
than run something else.

Sequence parallelism (parallel/sequence.py): inside ``sequence_parallel``
every rank of the group calls ``generate`` with the same inputs and
weights; the ViT block stack, the prefill layers and the resume layers
shard the sequence where it divides, and the keep policy, compaction and
decode run replicated on the gathered state, so every rank returns the
same result. The setting is read at each call, not when the runner is
built (the JAX runner binds it at trace time and warns when it changes,
:448-452, :872-881). The compressors run under SP too: visionzip,
divprune, cdpruner and vscan select on the replicated merged embeddings
(the ViT's importance scores sharded as vision.py says) and prefill the
compressed sequence through the SP layer stack, each call site sharded
where its length divides; pdrop's stages harvest the last text query's
row from the rank that holds it (language.run_layers) and the shortened
sequence is split again, or runs unsharded, at its next call.

Tensor parallelism (parallel/mesh.py): on a model sharded by
``shard_params`` every rank of the model axis calls ``generate`` with the
same inputs; the layers run their collectives, the decode cache holds the
local kv heads, and every rank returns the same result. A gloo collective
cannot be captured in a CUDA graph, so on a model sharded over a gloo group
the decode runs eagerly (``decode_mode``), chosen here and never as a
fallback from a failed capture.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from glimpseprune_torch.compressors import (
    cdpruner_select,
    divprune_select,
    staged_drop_schedule,
    visionzip_select,
)
from glimpseprune_torch.compressors.vscan import merge_dropped_into_kept, vscan_select
from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.models.qwen2_5_vl.decode_graph import DecodeGraphs, EagerSteps
from glimpseprune_torch.models.qwen2_5_vl.gp_model import (
    DecodeState,
    GlimpseOutputs,
    GlimpseState,
    Qwen2_5_VL_GP,
    _gather_packed,
    _gather_rows,
    _scatter_rows,
    sample_next,
)
from glimpseprune_torch.models.qwen2_5_vl.inputs import (
    PreparedInputs,
    _round_up,
    _vis_dense_hint,
)
from glimpseprune_torch.models.layers import QuantLinear, lora_rank, lora_state
from glimpseprune_torch.ops.compaction import (
    compaction_indices,
    gather_positions,
    gather_tokens,
)
from glimpseprune_torch.ops.kv_cache import (
    alloc_cache,
    cache_set_prefix,
    cache_t,
    is_quantized,
    quantize_kv,
)
from glimpseprune_torch.utils.profiling import debug_calls, time_logger

DECODE_CHUNK = 32  # default decode steps between host-side eos / stop-sequence checks


@dataclass
class GenerateResult:
    sequences: np.ndarray            # [B, max_new] generated ids (eos after the end)
    num_generated: np.ndarray        # [B]
    keep_img: Optional[np.ndarray]   # [B, N]
    mask_logits: Optional[np.ndarray]
    prune_ratio: Optional[np.ndarray]  # [B] fraction of image tokens dropped


class PrefillResult(NamedTuple):
    logits: torch.Tensor          # [B, 1, V] at the last position
    valid: torch.Tensor           # [B, R]
    position_ids: torch.Tensor    # [3, B, R]
    kv_k: torch.Tensor            # [L, B, R, Hkv, D]
    kv_v: torch.Tensor
    keep_img: Optional[torch.Tensor]     # [B, N], pruned prefill only
    mask_logits: Optional[torch.Tensor]  # [n_out, B, N], pruned prefill only


class CompressedPrefill(NamedTuple):
    logits: torch.Tensor          # [B, 1, V] at the last position
    input_ids: torch.Tensor       # [B, R] the compressed sequence's ids
    valid: torch.Tensor           # [B, R]
    position_ids: torch.Tensor    # [3, B, R]
    kv_k: torch.Tensor            # [L, B, R, Hkv, D]
    kv_v: torch.Tensor
    keep_img: Optional[torch.Tensor]  # [B, N]; None for pdrop (drops inside the LLM)
    kept: torch.Tensor            # [B] image tokens that reach the last layer


COMPRESSION_METHODS = ("visionzip", "divprune", "cdpruner", "vscan", "pdrop")


def _weight_tier(module: torch.nn.Module) -> str:
    """The weight tier a tower's modules are in: "none" without
    QuantLinears, "int4" if any is int4 (the int4 tier keeps int8 where no
    group splits a contraction dim), else "int8"."""
    modes = {m.mode for m in module.modules() if isinstance(m, QuantLinear)}
    return "int4" if "int4" in modes else ("int8" if modes else "none")


def check_config(cfg: ModelConfig, model: Qwen2_5_VL_GP) -> None:
    """Raise ValueError, naming the knob, for a config knob the port does
    not implement, or for a model whose weights are not in the tier the
    config declares."""
    if cfg.model_family not in ("qwen2_5_vl", "llava"):
        raise ValueError(f"model_family {cfg.model_family!r} is not ported to the torch runner")
    if model.model_family != cfg.model_family:
        raise ValueError(f"model_family is {cfg.model_family!r} but the model is a "
                         f"{type(model).__name__} of the {model.model_family!r} family: build "
                         "it from the config (convert.new_model)")
    have_rank = lora_rank(model.text)
    if have_rank != cfg.text.lora_rank:
        raise ValueError(f"text.lora_rank is {cfg.text.lora_rank} but the model's decoder "
                         f"carries adapters of rank {have_rank}: build the model from the "
                         "config, or attach them with training.lora.insert_lora")
    if cfg.text.kv_cache_quant not in ("none", "int8"):
        raise ValueError(f"text.kv_cache_quant must be none or int8, "
                         f"got {cfg.text.kv_cache_quant!r}")
    for name, tower, mod in (("vision", cfg.vision, model.visual), ("text", cfg.text, model.text)):
        if tower.weight_quant not in ("none", "int8", "int4"):
            raise ValueError(f"{name}.weight_quant must be none, int8 or int4, "
                             f"got {tower.weight_quant!r}")
        if tower.act_quant not in ("none", "int8", "prefill"):
            raise ValueError(f"{name}.act_quant must be none, int8 or prefill, "
                             f"got {tower.act_quant!r}")
        have = _weight_tier(mod)
        want = model.vision_weight_tier(cfg) if name == "vision" else tower.weight_quant
        if have != want:
            raise ValueError(f"{name}.weight_quant is {tower.weight_quant!r} but the model's "
                             f"{name} weights are {have!r}, not {want!r}: quantize the model "
                             "with quantization.quantize_model")
    check_binding(cfg, model)


# knobs the model never reads: the decode cache's tier is the runner's, and
# remat acts only under autograd (GPTrainer turns it on in the model's config)
_RUNNER_ONLY = ("text.kv_cache_quant", "text.remat")


def _fields(cfg) -> dict:
    """{"part.knob": value} of a config, its sub-configs flattened."""
    out = {}
    for key, val in dataclasses.asdict(cfg).items():
        if isinstance(val, dict):
            out.update({f"{key}.{k}": v for k, v in val.items()})
        else:
            out[key] = val
    return out


def check_binding(cfg: ModelConfig, model: Qwen2_5_VL_GP) -> None:
    """Raise ValueError, naming the knobs, unless the config the model is
    bound to agrees with cfg in every knob the model reads."""
    want, have = _fields(cfg), _fields(model.cfg)
    diff = [f"{k}: {have.get(k)!r}, not {v!r}" for k, v in want.items()
            if k not in _RUNNER_ONLY and have.get(k) != v]
    if diff:
        raise ValueError("the model is bound to another config (" + "; ".join(diff)
                         + "): bind it once with quantize_model(..., cfg=cfg) or "
                         "model.set_config(cfg)")


class GlimpsePruneRunner:
    """Owns the model (weights on their device) and runs generate(). The
    model's config is checked against the runner's at construction and
    again at each prefill and decode, so that a model re-bound since (to
    another tier) is refused, not run in it."""

    def __init__(self, cfg: ModelConfig, model: Qwen2_5_VL_GP):
        self.cfg = cfg.validate()
        check_config(self.cfg, model)
        self.model = model.eval()
        self.device = model.text.embed_tokens.weight.device
        self.decode_graphs = DecodeGraphs(self.model)

    @property
    def decode_mode(self) -> str:
        """"captured" (replays of one CUDA graph) or "eager": on the CPU, and
        on a model sharded over a process group that a graph cannot capture
        (gloo)."""
        mesh = getattr(self.model, "mesh", None)
        return ("captured" if self.device.type == "cuda" and (mesh is None or mesh.capturable)
                else "eager")

    def _device_inputs(self, prep: PreparedInputs, use_ref_masks: bool = False) -> dict:
        check_binding(self.cfg, self.model)
        def t(a, dtype=torch.long):
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

        d = {
            "input_ids": t(prep.input_ids),
            "valid": t(prep.valid, torch.bool),
            "position_ids": t(prep.position_ids),
            "patches": t(prep.patches, self.model.dtype),
            "vis_pos_ids": t(prep.vis_pos_ids),
            "full_seg": t(prep.full_seg, torch.int32),
            "vis_valid": t(prep.vis_valid, torch.bool),
            "packed_idx": t(prep.packed_idx),
            "img_slots": t(prep.img_slots),
            "img_valid": t(prep.img_valid, torch.bool),
            "img_group": t(prep.img_group),
            "fuser_window_index": t(prep.fuser.window_index),
            "fuser_reverse_index": t(prep.fuser.reverse_index),
            "fuser_segment_ids": t(prep.fuser.segment_ids, torch.int32),
            "fuser_pos_ids": t(prep.fuser.pos_ids),
            # each row's first image's merged (h, w), for VScan's windows
            "grid_hw": t(np.array([r[0] for r in prep.grid_hw_rows])
                         if prep.grid_hw_rows
                         else np.stack([prep.grids[:, 1], prep.grids[:, 2]], axis=-1) // 2),
        }
        d["le_start"] = None if prep.le_start is None else t(prep.le_start)
        d["anchor_mask"] = None if prep.anchor_mask is None else t(prep.anchor_mask, torch.bool)
        d["ref_token_masks"] = None
        if use_ref_masks:
            if prep.ref_token_masks is None:
                raise ValueError("use_ref_masks needs bboxes (prepare_inputs(normed_bboxes=...))")
            d["ref_token_masks"] = t(prep.ref_token_masks, torch.bool)
        return d

    def _vision(self, inputs: dict, prep: PreparedInputs, emit_importance: bool = False):
        return self.model.vision_encode(inputs["patches"], inputs["vis_pos_ids"],
                                        inputs["full_seg"], inputs["vis_valid"],
                                        dense_attn=_vis_dense_hint(prep),
                                        emit_importance=emit_importance)

    def _encode_kwargs(self, prep: PreparedInputs, use_ref_masks: bool):
        """The ViT, then (the anchor mask, ``glimpse_encode``'s keyword
        arguments)."""
        inputs = self._device_inputs(prep, use_ref_masks)
        merged, taps = self._vision(inputs, prep)
        return inputs["anchor_mask"], dict(
            input_ids=inputs["input_ids"], valid=inputs["valid"],
            position_ids=inputs["position_ids"], image_embeds=merged, taps=taps,
            packed_idx=inputs["packed_idx"], img_slots=inputs["img_slots"],
            img_valid=inputs["img_valid"],
            fuser_window_index=inputs["fuser_window_index"],
            fuser_reverse_index=inputs["fuser_reverse_index"],
            fuser_segment_ids=inputs["fuser_segment_ids"],
            fuser_pos_ids=inputs["fuser_pos_ids"], le_start=inputs["le_start"],
            img_group=inputs["img_group"], ref_token_masks=inputs["ref_token_masks"],
            use_ref_masks=use_ref_masks)

    @time_logger
    @debug_calls()
    @torch.inference_mode()
    def glimpse(self, prep: PreparedInputs, use_ref_masks: bool = False) -> GlimpseOutputs:
        """The pruned prefill: ViT, glimpse encode, keep policy, compaction
        and the remaining layers over the survivors. ``use_ref_masks``
        prunes with the prep's bbox masks (``ref_token_masks``) instead of
        the predicted ones."""
        return self._glimpse(prep, use_ref_masks)

    def _glimpse(self, prep: PreparedInputs, use_ref_masks: bool) -> GlimpseOutputs:
        # generate's pruned prefill calls this body, so that the profiling
        # stats hold one entry per public call, as JAX's do
        anchor, kwargs = self._encode_kwargs(prep, use_ref_masks)
        return self.model.glimpse_prefill(prep.out_len, anchor_mask=anchor, **kwargs)

    @torch.inference_mode()
    def glimpse_delayed(self, prep: PreparedInputs, use_ref_masks: bool = False,
                        training: bool = False) -> Tuple[torch.Tensor, GlimpseState]:
        """Delayed selection, phase 1 (JAX :777-815): the ViT and
        ``glimpse_encode`` -> (mask_logits [n_out, B, N], GlimpseState).
        Pass the logits, or others in their place, to ``apply_selection``."""
        _, kwargs = self._encode_kwargs(prep, use_ref_masks)
        mask_logits, state, _ = self.model.glimpse_encode(training=training, **kwargs)
        return mask_logits, state

    @torch.inference_mode()
    def apply_selection(self, state: GlimpseState, mask_logits: torch.Tensor, out_len: int,
                        anchor_mask: Optional[torch.Tensor] = None) -> GlimpseOutputs:
        """Delayed selection, phase 2 (JAX :817-836): the keep policy on
        mask_logits [n_out, B, N] (possibly overridden), the compaction to
        out_len slots and the remaining layers."""
        check_binding(self.cfg, self.model)
        return self.model.reduce_and_resume(state, mask_logits, out_len, anchor_mask)

    @torch.inference_mode()
    def harvest_rows(self, prep: PreparedInputs, layers: Optional[Sequence[int]] = None,
                     q_start: Optional[int] = None) -> dict:
        """Attention rows per layer and head over the image tokens, for
        visualization (JAX :707-775), from a prefill of layers 0..max(layers)
        without the glimpse embeddings. q_start None: {layer: [B, N, Hq]},
        the last position's log-prob rows (clamped at -1e30), or its raw
        logits under ``gp.use_attention_logits``; q_start an int: {layer:
        [B, S - q_start, N, Hq]}, the softmax rows of every query from
        q_start on. Invalid image slots hold 0."""
        cfg = self.cfg
        layers = tuple(layers) if layers else tuple(cfg.gp.selected_layers)
        inputs = self._device_inputs(prep)
        merged, _ = self._vision(inputs, prep)
        slots, img_valid = inputs["img_slots"], inputs["img_valid"]
        embeds = self.model.embed_with_images(inputs["input_ids"], merged, inputs["packed_idx"],
                                              slots, img_valid)
        cos, sin = self.model._cos_sin(inputs["position_ids"])
        _, _, harvests = self.model.text.run_layers(
            embeds, cos, sin, inputs["valid"], layer_end=max(layers), harvest_layers=layers,
            use_attention_logits=cfg.gp.use_attention_logits, collect_kv=False,
            harvest_q_start=q_start)
        if q_start is None:
            return {l: _gather_rows(row.clamp(min=-1e30), slots, img_valid)
                    for l, row in harvests.items()}
        return {l: _gather_rows(row.transpose(1, 2), slots, img_valid).transpose(1, 2)
                for l, row in harvests.items()}

    @torch.inference_mode()
    def prefill(self, prep: PreparedInputs, do_selection: bool = True,
                use_ref_masks: bool = False) -> PrefillResult:
        """Pruned (do_selection) or unpruned prefill up to the first logits."""
        if do_selection:
            out = self._glimpse(prep, use_ref_masks)
            return PrefillResult(out.logits, out.valid, out.position_ids, out.kv_k,
                                 out.kv_v, out.keep_img, out.mask_logits)
        inputs = self._device_inputs(prep)
        merged, _ = self._vision(inputs, prep)
        ids, valid, pos = inputs["input_ids"], inputs["valid"], inputs["position_ids"]
        gp = self.cfg.gp
        le_len = gp.le_length if gp.has_le else 0
        if le_len:  # the unpruned model has no glimpse slots; they are trailing
            ids, valid, pos = ids[:, :-le_len], valid[:, :-le_len], pos[:, :, :-le_len]
        # generation reads only the last position's logits
        logits, kv_k, kv_v = self.model.vanilla_prefill(
            ids, valid, pos, merged, inputs["packed_idx"], inputs["img_slots"],
            inputs["img_valid"], logits_last_only=True)
        return PrefillResult(logits, valid, pos, kv_k, kv_v, None, None)

    @torch.inference_mode()
    def vanilla_prefill_chunked(self, prep: PreparedInputs, chunk_size: int,
                                prealloc_t: Optional[int] = None):
        """The unpruned prefill in chunks of ``chunk_size`` tokens straight
        into a decode-ready cache (JAX :938-973): each chunk is one
        ``prefill_chunk``, its new tokens causal among themselves and
        against the slots already written. Returns (logits [B, 1, V] at
        the last real slot, valid [B, S], position_ids [3, B, S], k_cache,
        v_cache), the caches [L, B, T, Hkv, D] with T = max(prealloc_t or S,
        the chunks' padded length): pass them to ``_decode_loop(...,
        prealloc_t=T)``. The chunks attend over a cache in the model's
        dtype; under the int8 KV tier it is quantized once, at the end, as
        the monolithic prefill's cache is built."""
        gen = self._chunked_prefill_gen(prep, chunk_size, prealloc_t)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                logits, valid, pos, kc, vc = stop.value
                break
        if self.cfg.text.kv_cache_quant == "int8":
            kc, vc = ({"q": q, "s": sc} for q, sc in (quantize_kv(kc), quantize_kv(vc)))
        return logits, valid, pos, kc, vc

    def vanilla_prefill_chunked_steps(self, prep: PreparedInputs, chunk_size: int):
        """The chunked prefill as a generator for serving admission (JAX
        :975-985): it yields after every chunk but the last (the continuous
        batcher decodes there) and returns (logits, valid, position_ids,
        kv_k, kv_v) with the caches sliced to the S real slots and kept in
        the model's dtype: the batcher's ``cache_fill_rows`` applies its
        cache tier."""
        logits, valid, pos, kc, vc = yield from self._chunked_prefill_gen(prep, chunk_size,
                                                                          None)
        s = valid.shape[1]
        return logits, valid, pos, kc[:, :, :s], vc[:, :, :s]

    @torch.inference_mode()
    def _chunked_prefill_gen(self, prep: PreparedInputs, chunk_size: int,
                             prealloc_t: Optional[int]):
        """(JAX :987-1051) The trailing glimpse slots are dropped, the
        tail chunk is padded to n_chunks * C with invalid slots, and each
        chunk's head runs on one slot: its last, or in the last chunk the
        last real slot. Each chunk runs eagerly."""
        cfg = self.cfg
        inputs = self._device_inputs(prep)
        ids, valid, pos = inputs["input_ids"], inputs["valid"], inputs["position_ids"]
        le_len = cfg.gp.le_length if cfg.gp.has_le else 0
        if le_len:
            ids, valid, pos = ids[:, :-le_len], valid[:, :-le_len], pos[:, :, :-le_len]
        b, s = ids.shape
        c = int(chunk_size)
        n_chunks = -(-s // c)
        sp = n_chunks * c
        merged, _ = self._vision(inputs, prep)
        embeds = self.model.embed_with_images(ids, merged, inputs["packed_idx"],
                                              inputs["img_slots"], inputs["img_valid"])
        embeds = torch.nn.functional.pad(embeds, (0, 0, 0, sp - s))
        pos_p = torch.nn.functional.pad(pos, (0, sp - s))
        t = max(s if prealloc_t is None else int(prealloc_t), sp)
        shape = (cfg.text.num_hidden_layers, b, t, self.model.text.kv_heads, cfg.text.head_dim)
        k_cache, v_cache = (alloc_cache(shape, embeds.dtype, self.device) for _ in range(2))
        kv_valid = torch.cat([valid, valid.new_zeros((b, t - s))], 1)
        rel = (s - 1) - (n_chunks - 1) * c
        for i in range(n_chunks):
            last = i == n_chunks - 1
            sl = slice(i * c, (i + 1) * c)
            logits, k_cache, v_cache = self.model.prefill_chunk(
                embeds[:, sl], pos_p[:, :, sl], k_cache, v_cache, kv_valid, i * c,
                kv_valid[:, sl], rel if last else c - 1)
            if not last:
                yield i
        return logits, valid, pos, k_cache, v_cache

    @time_logger
    @debug_calls()
    @torch.inference_mode()
    def generate(self, prep: PreparedInputs, max_new_tokens: int = 128,
                 do_selection: bool = True, eos_token_id: Optional[int] = None,
                 stop_sequences: Optional[Sequence[Sequence[int]]] = None,
                 check_eos_every: Optional[int] = None, temperature: float = 0.0,
                 rng: Optional[torch.Generator] = None,
                 use_ref_masks: bool = False) -> GenerateResult:
        """Generation after the pruned (do_selection) or unpruned prefill
        (JAX :848-936); ``use_ref_masks`` prunes with the prep's bbox masks.
        stop_sequences: token-id sequences; a matched row
        stops and is trimmed before the match (plain eos is trimmed
        inclusively). check_eos_every: the decode chunk, the steps between
        the host's early-exit checks (None: 32). temperature > 0 samples
        from softmax(logits / temperature) with rng (a torch.Generator on
        the model's device; None: seed 0), else greedy."""
        eos = self.cfg.eos_token_id if eos_token_id is None else eos_token_id
        pre = self.prefill(prep, do_selection, use_ref_masks)
        chunk = DECODE_CHUNK if check_eos_every is None else max(1, check_eos_every)
        seqs, n_gen = self._decode_loop(pre.logits, pre.valid, pre.position_ids, pre.kv_k,
                                        pre.kv_v, max_new_tokens, eos, temperature, rng,
                                        chunk, stop_sequences=stop_sequences)
        return self._result(prep, pre, seqs, n_gen)

    @torch.inference_mode()
    def stream_generate(self, prep: PreparedInputs, max_new_tokens: int = 128,
                        do_selection: bool = True, eos_token_id: Optional[int] = None,
                        chunk_size: int = 4, temperature: float = 0.0,
                        rng: Optional[torch.Generator] = None,
                        stop_sequences: Optional[Sequence[Sequence[int]]] = None,
                        use_ref_masks: bool = False):
        """Streaming generation (JAX :1192-1237): yields each [B, chunk_size]
        block of new tokens (numpy, before eos trimming) as its chunk lands;
        the GenerateResult, as ``generate`` returns it, is the generator's
        return value (``res = yield from runner.stream_generate(...)``)."""
        eos = self.cfg.eos_token_id if eos_token_id is None else eos_token_id
        pre = self.prefill(prep, do_selection, use_ref_masks)
        seqs = yield from self._run_decode(pre.logits, pre.valid, pre.position_ids, pre.kv_k,
                                           pre.kv_v, max_new_tokens, eos, temperature, rng,
                                           chunk_size, stop_sequences=stop_sequences)
        seqs, n_gen = self._trim_eos(seqs, max_new_tokens, eos, stop_sequences)
        return self._result(prep, pre, seqs, n_gen)

    @staticmethod
    def _result(prep: PreparedInputs, pre: PrefillResult, seqs, n_gen) -> GenerateResult:
        keep_img = mask_logits = prune_ratio = None
        if pre.keep_img is not None:
            keep_img = pre.keep_img.cpu().numpy()
            mask_logits = pre.mask_logits.float().cpu().numpy()
            prune_ratio = 1.0 - keep_img.sum(1) / np.maximum(prep.n_img_tokens, 1)
        return GenerateResult(sequences=seqs, num_generated=n_gen, keep_img=keep_img,
                              mask_logits=mask_logits, prune_ratio=prune_ratio)

    @torch.inference_mode()
    def prefill_compressed(
        self, prep: PreparedInputs, method: str, visual_token_num: Optional[int] = None,
        dominant_ratio: float = 0.65, contextual_ratio: float = 0.05,
        stages: Tuple[Tuple[int, float], ...] = ((8, 0.5), (16, 0.25), (24, 0.125)),
        clip_text_ids=None,
    ) -> CompressedPrefill:
        """The prefill of a baseline compressor (JAX :1243-1326): visionzip,
        divprune, cdpruner and vscan select image tokens before the LLM and
        prefill the compressed sequence; pdrop drops them inside it at the
        ``stages`` (layer, keep ratio). The glimpse tokens are stripped:
        compressors run without them."""
        if method not in COMPRESSION_METHODS:
            raise ValueError(f"unknown compressor {method!r}; one of {COMPRESSION_METHODS}")
        cfg = self.cfg
        inputs = self._device_inputs(prep)
        relevance = None
        if clip_text_ids is not None:
            if getattr(self.model, "clip_text", None) is None or method != "cdpruner":
                raise ValueError("clip_text_ids (CDPruner's CLIP-text relevance) needs a LLaVA "
                                 "model with the CLIP text tower (built with_text_tower) and "
                                 f"method 'cdpruner', not a {type(self.model).__name__} and "
                                 f"{method!r}")
            relevance = self.model.cdpruner_relevance(
                inputs["patches"], torch.as_tensor(np.asarray(clip_text_ids), device=self.device))
        le_len = cfg.gp.le_length if cfg.gp.has_le else 0
        if le_len:  # the glimpse slots are trailing
            inputs["input_ids"] = inputs["input_ids"][:, :-le_len]
            inputs["valid"] = inputs["valid"][:, :-le_len]
            inputs["position_ids"] = inputs["position_ids"][:, :, :-le_len]
        s = int(inputs["input_ids"].shape[1])
        seq_mult = 64 if prep.input_ids.shape[1] % 64 == 0 else 8
        if method == "pdrop":
            stages = tuple((l, r) for l, r in stages if l < cfg.text.num_hidden_layers)
            out_lens = staged_drop_schedule(int(prep.n_img_tokens.max()), s, stages,
                                            round_to=seq_mult)
            merged, _ = self._vision(inputs, prep)
            logits, ids, valid, pos, kv_k, kv_v, is_img = self.model.staged_prefill(
                inputs["input_ids"], inputs["valid"], inputs["position_ids"], merged,
                inputs["packed_idx"], inputs["img_slots"], inputs["img_valid"], stages,
                out_lens)
            return CompressedPrefill(logits, ids, valid, pos, kv_k, kv_v, None,
                                     is_img.sum(-1))
        n = prep.img_valid.shape[1]
        if method == "vscan":
            keep_budget = visual_token_num or max(int(0.222 * n), 2)
        else:
            keep_budget = visual_token_num or max(int((dominant_ratio + contextual_ratio) * n)
                                                  + 2, 1)
        out_len = _round_up(s - int(prep.n_img_tokens.min()) + min(keep_budget, n), seq_mult)
        out_len = min(out_len, s)
        return self._pre_llm_compress(inputs, prep, method, keep_budget, out_len,
                                      dominant_ratio, contextual_ratio, relevance)

    def _pre_llm_compress(self, inputs: dict, prep: PreparedInputs, method: str, k: int,
                          out_len: int, dominant_ratio: float, contextual_ratio: float,
                          relevance: Optional[torch.Tensor] = None) -> CompressedPrefill:
        """Select image tokens before the LLM, compact, prefill (JAX
        :542-663). CDPruner's relevance is ``relevance`` [Pm] packed where
        given (LLaVA's CLIP-text relevance, JAX :614-622), else the negated
        cosine similarity of each image token to the mean text-token
        embedding (JAX :624-641)."""
        model = self.model
        input_ids, valid = inputs["input_ids"], inputs["valid"]
        packed_idx, img_slots, img_valid = (inputs["packed_idx"], inputs["img_slots"],
                                            inputs["img_valid"])

        def rows_of(packed):  # packed [Pm] or [Pm, D] -> [B, N] or [B, N, D]
            if packed.ndim == 1:
                return _gather_packed(packed[:, None], packed_idx, img_valid)[..., 0]
            return _gather_packed(packed, packed_idx, img_valid)

        vis = self._vision(inputs, prep, emit_importance=method in ("visionzip", "vscan"))
        rows = rows_of(vis[0])
        is_img = _scatter_rows(torch.zeros_like(valid), img_slots, img_valid, img_valid)
        if method == "visionzip":
            received, keys_mean, _ = vis[2]
            keep_img, rows = visionzip_select(rows, rows_of(received), rows_of(keys_mean),
                                              img_valid, dominant_ratio, contextual_ratio)
        elif method == "vscan":
            received, _, received_local = vis[2]
            keep_img = vscan_select(rows_of(received_local), rows_of(received), img_valid,
                                    inputs["grid_hw"], k)
            rows = merge_dropped_into_kept(rows, keep_img, img_valid)
        elif method == "divprune":
            keep_img = divprune_select(rows, img_valid, k)
        elif relevance is not None:  # cdpruner over the CLIP-text relevance
            keep_img = cdpruner_select(rows, rows_of(relevance), img_valid, k)
        else:  # cdpruner
            embeds0 = model.text.embed(input_ids)
            text_mask = (valid & ~is_img)[..., None]
            text_mean = (embeds0 * text_mask).sum(1) / text_mask.sum(1).clamp(min=1)
            rn = rows / torch.linalg.vector_norm(rows.float(), dim=-1,
                                                 keepdim=True).clamp(min=1e-8)
            tn = text_mean / torch.linalg.vector_norm(text_mean.float(), dim=-1,
                                                      keepdim=True).clamp(min=1e-8)
            relevance = -torch.einsum("bnd,bd->bn", rn.float(), tn.float())
            keep_img = cdpruner_select(rows, relevance, img_valid, k)

        embeds = _scatter_rows(model.text.embed(input_ids), img_slots, rows, img_valid)
        keep = (valid & ~is_img) | _scatter_rows(torch.zeros_like(valid), img_slots, keep_img,
                                                 img_valid)
        plan = compaction_indices(keep, out_len)
        r_ids = gather_tokens(input_ids, plan, fill=self.cfg.pad_token_id)
        r_pos = gather_positions(inputs["position_ids"], plan)
        logits, kv_k, kv_v = model.prefill_embeds(gather_tokens(embeds, plan), plan.valid,
                                                  r_pos)
        return CompressedPrefill(logits, r_ids, plan.valid, r_pos, kv_k, kv_v, keep_img,
                                 keep_img.sum(-1))

    @time_logger
    @torch.inference_mode()
    def generate_compressed(
        self, prep: PreparedInputs, method: str, max_new_tokens: int = 128,
        visual_token_num: Optional[int] = None, dominant_ratio: float = 0.65,
        contextual_ratio: float = 0.05,
        stages: Tuple[Tuple[int, float], ...] = ((8, 0.5), (16, 0.25), (24, 0.125)),
        eos_token_id: Optional[int] = None, clip_text_ids=None,
        stop_sequences: Optional[Sequence[Sequence[int]]] = None,
    ) -> GenerateResult:
        """Run a baseline compressor end to end with greedy decoding:
        visionzip / divprune / cdpruner / vscan prune before the LLM, pdrop
        prunes inside it. visual_token_num is the image-token budget of
        divprune, cdpruner and vscan; clip_text_ids [M, 77] (zero-padded
        question segments; a LLaVA model built with the CLIP text tower)
        switches CDPruner's relevance to the CLIP-text one (JAX
        :1259-1269)."""
        eos = self.cfg.eos_token_id if eos_token_id is None else eos_token_id
        pre = self.prefill_compressed(prep, method, visual_token_num, dominant_ratio,
                                      contextual_ratio, stages, clip_text_ids)
        seqs, n_gen = self._decode_loop(pre.logits, pre.valid, pre.position_ids, pre.kv_k,
                                        pre.kv_v, max_new_tokens, eos,
                                        stop_sequences=stop_sequences)
        kept = pre.kept.cpu().numpy()
        return GenerateResult(
            sequences=seqs, num_generated=n_gen,
            keep_img=None if pre.keep_img is None else pre.keep_img.cpu().numpy(),
            mask_logits=None,
            prune_ratio=1.0 - kept / np.maximum(prep.n_img_tokens, 1))

    def _decode_loop(self, logits, r_valid, r_pos, kv_k, kv_v, max_new_tokens, eos,
                     temperature: float = 0.0, rng: Optional[torch.Generator] = None,
                     chunk_size: int = DECODE_CHUNK, prealloc_t: Optional[int] = None,
                     stop_sequences=None):
        """Decode over a prefill's KV and trim it (JAX :1053-1080): ->
        (seqs [B, max_new_tokens], num_generated [B]). prealloc_t: kv_k and
        kv_v are already the whole decode cache [L, B, prealloc_t, Hkv, D]
        with the R prefix slots written (r_valid stays [B, R]); the decode
        writes into it."""
        gen = self._run_decode(logits, r_valid, r_pos, kv_k, kv_v, max_new_tokens, eos,
                               temperature, rng, chunk_size, prealloc_t, stop_sequences)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return self._trim_eos(stop.value, max_new_tokens, eos, stop_sequences)

    @staticmethod
    def _first_stop_match(row: np.ndarray, stop_sequences) -> int:
        """Earliest start index of any stop id-sequence in row, or -1."""
        best = -1
        for seq in stop_sequences:
            seq = np.asarray(seq, dtype=row.dtype)
            n = len(seq)
            if n == 0 or n > len(row):
                continue
            win = np.lib.stride_tricks.sliding_window_view(row, n)
            hits = np.nonzero((win == seq).all(axis=1))[0]
            if len(hits) and (best < 0 or hits[0] < best):
                best = int(hits[0])
        return best

    def _trim_eos(self, seqs, max_new_tokens, eos, stop_sequences=None):
        """Everything after the first eos (inclusive) or before the first
        stop sequence (exclusive) becomes eos; counts generated tokens."""
        seqs = seqs[:, :max_new_tokens]
        n_gen = np.zeros((seqs.shape[0],), dtype=np.int64)
        for b in range(seqs.shape[0]):
            hits = np.nonzero(seqs[b] == eos)[0]
            end = int(hits[0]) + 1 if len(hits) else max_new_tokens
            if stop_sequences:
                s = self._first_stop_match(seqs[b, :end], stop_sequences)
                if s >= 0:
                    end = s
            n_gen[b] = end
            seqs[b, end:] = eos
        return seqs, n_gen

    def decode_cache(self, kv: torch.Tensor, t: int):
        """The decode cache [L, B, t, Hkv, D] with the prefill's kv [L, B, R,
        Hkv, D] in its first R slots, in the config's ``kv_cache_quant``
        tier (int8: quantized here, once)."""
        shape = kv.shape[:2] + (t,) + kv.shape[3:]
        cache = alloc_cache(shape, kv.dtype, self.device, self.cfg.text.kv_cache_quant)
        return cache_set_prefix(cache, kv)

    @torch.inference_mode()
    def decode_steps(self, logits, r_valid, r_pos, kv_k, kv_v, t: int, eos: int,
                     temperature: float = 0.0, rng: Optional[torch.Generator] = None,
                     prealloc: bool = False):
        """The steps of a decode, begun: the first token from the prefill's
        last logits (argmax, or a sample from rng), the prefill's KV in the
        runner's static cache of t slots (or, with ``prealloc``, kv_k and
        kv_v are the caller's whole cache, prefix written, which a captured
        step's state then lets go of), kv_valid the prefix's r_valid [B, R]
        then False. On a CUDA model a captured step
        (decode_graph.StepGraph), else the step run eagerly; either one's
        ``run(n, rng)`` takes n steps and its ``state`` holds the tokens
        (``toks[:, s]``, the token fed at step s) and the done flags."""
        model = self.model
        b, r = r_valid.shape
        sampled = temperature > 0
        last = logits[:, -1]
        noise = (torch.rand(last.shape, generator=rng, device=last.device)
                 if sampled else None)
        first = sample_next(last, temperature if sampled else None, noise)

        def make_state() -> DecodeState:
            caches = ((kv_k, kv_v) if prealloc else
                      (self.decode_cache(kv_k, t), self.decode_cache(kv_v, t)))
            return DecodeState.alloc(*caches, t, self.cfg.text.vocab_size, sampled)

        def begin(st: DecodeState) -> None:
            if not prealloc:
                cache_set_prefix(st.k_cache, kv_k)
                cache_set_prefix(st.v_cache, kv_v)
            st.kv_valid[:, :r] = r_valid
            st.kv_valid[:, r:] = False
            st.begin(first, r_pos[:, :, -1], r, eos, temperature)

        if self.decode_mode == "eager":
            st = make_state()
            begin(st)
            return EagerSteps(model, st)
        owner = None
        if prealloc:  # the graph writes the caller's buffers: they key it
            owner = tuple((x.data_ptr(), x.dtype, x.shape, x.stride()) for c in (kv_k, kv_v)
                          for x in (c.values() if is_quantized(c) else [c]))
        # a step captured with the adapters on computes another model than
        # one captured under lora_disabled: their state is part of the key
        key = (b, t, self.cfg.text.kv_cache_quant, sampled, owner, lora_state(model.text))
        steps = self.decode_graphs.steps(key, make_state, begin)
        if prealloc:
            # replays write by address, which the key holds: a kept graph
            # keeps no reference, so the caller's cache goes when they drop
            # it, and a new cache at the same address with the same layout
            # is the memory the graph writes
            steps.state.k_cache = steps.state.v_cache = None
        return steps

    @torch.inference_mode()
    def _run_decode(self, logits, r_valid, r_pos, kv_k, kv_v, max_new_tokens, eos,
                    temperature: float = 0.0, rng: Optional[torch.Generator] = None,
                    chunk_size: int = DECODE_CHUNK, prealloc_t: Optional[int] = None,
                    stop_sequences=None):
        """The decode loop, a generator (JAX :1114-1190): chunks of
        ``chunk_size`` steps, yielding each [B, chunk] block of tokens as
        it lands; returns seqs [B, n_chunks * chunk] (the token emitted at
        each step; eos once a row is done). The host reads the block and
        the done flags at each chunk's end, and stops once every row is
        done or has matched a stop sequence."""
        check_binding(self.cfg, self.model)
        b, r = r_valid.shape
        chunk = max(1, min(chunk_size, max_new_tokens))
        n_chunks = -(-max_new_tokens // chunk)
        if prealloc_t is None:
            t = r + n_chunks * chunk
        else:
            if prealloc_t < r + n_chunks * chunk:
                raise ValueError(f"prealloc_t={prealloc_t} < R + max_new rounded "
                                 f"({r} + {n_chunks * chunk})")
            if cache_t(kv_k) != prealloc_t:
                raise ValueError(f"prealloc_t={prealloc_t} is not the cache's "
                                 f"{cache_t(kv_k)} slots")
            t = int(prealloc_t)
        if temperature > 0 and rng is None:
            rng = torch.Generator(self.device).manual_seed(0)
        steps = self.decode_steps(logits, r_valid, r_pos, kv_k, kv_v, t, eos, temperature, rng,
                                  prealloc=prealloc_t is not None)
        seqs = np.full((b, n_chunks * chunk), eos, dtype=np.int64)
        for ci in range(n_chunks):
            steps.run(chunk, rng)
            block = slice(ci * chunk, (ci + 1) * chunk)
            toks = steps.state.toks[:, block].cpu().numpy()
            seqs[:, block] = toks
            yield toks
            finished = steps.state.done.cpu().numpy()
            if stop_sequences:  # a matched row counts as done
                finished = finished | np.array([
                    self._first_stop_match(seqs[i, :block.stop], stop_sequences) >= 0
                    for i in range(b)])
            if finished.all():
                break
        return seqs

"""HF LLaVA-1.5 checkpoint (CLIP tower + Llama + mm projector) -> the
port's state dict for ``Llava_GP``.

Counterpart of glimpseprune_tpu/models/llava/convert.py
(``_strip_llava_prefixes`` :23, ``_clip_block`` :44, ``convert_clip`` :61,
``convert_clip_text`` :78, ``convert_llava_state_dict`` :96). It accepts
the merged llava-1.5 layout (``model.vision_tower.vision_tower.
vision_model.*``, ``model.mm_projector.{0,2}.*``, ``model.layers.*``) and
the separate ``CLIPVisionModel`` (``vision_model.*``) and
``LlamaForCausalLM`` (``model.*``, ``lm_head.*``) dicts, merged into one
mapping. The decoder goes through the Qwen converter's ``convert_text``.
HF's layouts are the port's (the Conv2d patch weight [out, in, kh, kw]
included), so tensors pass through without a copy. The CDPruner towers
(``visual_projection``, ``post_layernorm``, the text tower) are converted
only under ``clip_cfg.with_text_tower``; the GlimpsePrune modules are not
in an HF checkpoint (``convert.init_random(..., base=...)``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from glimpseprune_torch.config import ModelConfig
from glimpseprune_torch.models.llava.gp_model import CLIPTowerConfig
from glimpseprune_torch.models.qwen2_5_vl.convert import _dense, _t, convert_text


def _ln(sd: Mapping[str, Any], name: str, dest: str) -> Dict[str, torch.Tensor]:
    return {f"{dest}.weight": _t(sd[f"{name}.weight"]), f"{dest}.bias": _t(sd[f"{name}.bias"])}


def _strip_llava_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in sd.items():
        nk = k
        for old, new in (
            ("model.vision_tower.vision_tower.vision_model.", "clip."),
            ("vision_tower.vision_model.", "clip."),
            ("vision_model.", "clip."),
            ("model.mm_projector.", "projector."),
            ("mm_projector.", "projector."),
            ("model.layers.", "language.layers."),
            ("model.embed_tokens.", "language.embed_tokens."),
            ("model.norm.", "language.norm."),
        ):
            if nk.startswith(old):
                nk = new + nk[len(old):]
                break
        out[nk] = v
    return out


def _clip_block(sd: Mapping[str, Any], b: str, dest: str) -> Dict[str, torch.Tensor]:
    out = {**_ln(sd, f"{b}.layer_norm1", f"{dest}.layer_norm1"),
           **_ln(sd, f"{b}.layer_norm2", f"{dest}.layer_norm2")}
    for proj in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                 "self_attn.out_proj", "mlp.fc1", "mlp.fc2"):
        out.update(_dense(sd, f"{b}.{proj}", f"{dest}.{proj}", bias=True))
    return out


def convert_clip(sd: Mapping[str, Any], clip_cfg: CLIPTowerConfig) -> Dict[str, torch.Tensor]:
    """The CLIP vision tower's weights (``visual.*``), from a dict in the
    stripped key space; ``post_layernorm`` and ``visual_projection`` where
    the dict holds the projection (a ``CLIPVisionModelWithProjection``'s)
    and ``with_text_tower`` asks for them."""
    out = {
        "visual.patch_embedding.weight": _t(sd["clip.embeddings.patch_embedding.weight"]),
        "visual.class_embedding": _t(sd["clip.embeddings.class_embedding"]),
        "visual.position_embedding": _t(sd["clip.embeddings.position_embedding.weight"]),
        **_ln(sd, "clip.pre_layrnorm", "visual.pre_layrnorm"),
    }
    for i in range(clip_cfg.depth):
        out.update(_clip_block(sd, f"clip.encoder.layers.{i}", f"visual.layers.{i}"))
    if clip_cfg.with_text_tower and "visual_projection.weight" in sd:
        out.update(_ln(sd, "clip.post_layernorm", "visual.post_layernorm"))
        out["visual.visual_projection.weight"] = _t(sd["visual_projection.weight"])
    return out


def convert_clip_text(sd: Mapping[str, Any],
                      clip_cfg: CLIPTowerConfig) -> Dict[str, torch.Tensor]:
    """A ``CLIPTextModelWithProjection`` state dict -> the text tower's
    weights (``clip_text.*``), CDPruner's relevance tower."""
    out = {
        "clip_text.token_embedding.weight": _t(sd["text_model.embeddings.token_embedding.weight"]),
        "clip_text.position_embedding": _t(sd["text_model.embeddings.position_embedding.weight"]),
        **_ln(sd, "text_model.final_layer_norm", "clip_text.final_layer_norm"),
        "clip_text.text_projection.weight": _t(sd["text_projection.weight"]),
    }
    for i in range(clip_cfg.text_depth):
        out.update(_clip_block(sd, f"text_model.encoder.layers.{i}", f"clip_text.layers.{i}"))
    return out


def convert_llava_state_dict(state_dict: Mapping[str, Any], cfg: ModelConfig,
                             clip_cfg: CLIPTowerConfig) -> Dict[str, torch.Tensor]:
    """An HF LLaVA-1.5 state dict (merged, or the CLIP and Llama dicts in
    one mapping) -> the port's state dict of the CLIP tower, the projector
    (where the dict holds it) and the decoder."""
    sd = _strip_llava_prefixes(state_dict)
    out = {**convert_clip(sd, clip_cfg), **convert_text(sd, cfg)}
    if "projector.0.weight" in sd:
        out.update(_dense(sd, "projector.0", "mm_projector_fc1", bias=True))
        out.update(_dense(sd, "projector.2", "mm_projector_fc2", bias=True))
    return out

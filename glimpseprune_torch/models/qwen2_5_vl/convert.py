"""HF Qwen2.5-VL checkpoint -> the port's state dict for ``Qwen2_5_VL_GP``.

Counterpart of glimpseprune_tpu/models/qwen2_5_vl/convert.py (``_np`` :19,
``_dense`` :29, ``_norm`` :36, ``_strip_prefixes`` :40, ``convert_vision``
:60, ``convert_text`` :90, ``convert_hf_state_dict`` :126,
``hf_config_to_model_config`` :131). It reads either key layout of the HF
state dict (transformers 4.5x ``model.visual.*`` / ``model.language_model.*``,
or the older ``visual.*`` / ``model.*``). HF's ``nn.Linear`` weights are
already in the port's [out, in] layout, so nothing is transposed; the
Conv3d patch embed [hidden, C, T, P, P] becomes the ``Linear`` weight
[hidden, C * T * P * P], whose columns are the (C, T, H, W) order the
patchified rows hold. The port keeps one module per layer, so nothing is
stacked. Tensors keep their dtype and device: a converted dict shares the
HF dict's storage. The GlimpsePrune modules are not in an HF checkpoint:
``convert.init_random(..., base=...)`` draws them around the converted
weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from glimpseprune_torch.config import GPConfig, ModelConfig, TextConfig, VisionConfig


def _t(x) -> torch.Tensor:
    """A state-dict value (a tensor, or an array from a numpy checkpoint)
    as a tensor, sharing its storage where it can."""
    return x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _dense(sd: Mapping[str, Any], name: str, dest: str, bias: bool) -> Dict[str, torch.Tensor]:
    out = {f"{dest}.weight": _t(sd[f"{name}.weight"])}
    if bias:
        out[f"{dest}.bias"] = _t(sd[f"{name}.bias"])
    return out


def _norm(sd: Mapping[str, Any], name: str, dest: str) -> Dict[str, torch.Tensor]:
    return {f"{dest}.weight": _t(sd[f"{name}.weight"])}


def _strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Normalize to the {visual.*, language.*, lm_head.*} key space."""
    out = {}
    for k, v in sd.items():
        nk = k
        for old, new in (
            ("model.visual.", "visual."),
            ("model.language_model.", "language."),
            ("language_model.model.", "language."),
            ("model.layers.", "language.layers."),
            ("model.embed_tokens.", "language.embed_tokens."),
            ("model.norm.", "language.norm."),
        ):
            if nk.startswith(old):
                nk = new + nk[len(old):]
                break
        out[nk] = v
    return out


def convert_vision(sd: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The ViT's weights, from a dict in the stripped key space."""
    v = cfg.vision
    pe = _t(sd["visual.patch_embed.proj.weight"])  # [hidden, C, T, P, P]
    out = {"visual.patch_embed.weight": pe.reshape(v.hidden_size, -1)}
    for i in range(v.depth):
        b = f"visual.blocks.{i}"  # the port's names are HF's
        out.update(_norm(sd, f"{b}.norm1", f"{b}.norm1"))
        out.update(_norm(sd, f"{b}.norm2", f"{b}.norm2"))
        for proj in ("attn.qkv", "attn.proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"):
            out.update(_dense(sd, f"{b}.{proj}", f"{b}.{proj}", bias=True))
    out.update(_norm(sd, "visual.merger.ln_q", "visual.merger_ln_q"))
    out.update(_dense(sd, "visual.merger.mlp.0", "visual.merger_fc1", bias=True))
    out.update(_dense(sd, "visual.merger.mlp.2", "visual.merger_fc2", bias=True))
    return out


def convert_text(sd: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The decoder's weights (Qwen2 or Llama: ``attention_bias`` says
    whether q, k, v carry a bias), from a dict in the stripped key space.
    An untied config takes ``lm_head.weight``, or the embedding of a tied
    checkpoint; a tied one has no head."""
    t = cfg.text
    out = {"text.embed_tokens.weight": _t(sd["language.embed_tokens.weight"])}
    out.update(_norm(sd, "language.norm", "text.norm"))
    for i in range(t.num_hidden_layers):
        b, d = f"language.layers.{i}", f"text.layers.{i}"
        out.update(_norm(sd, f"{b}.input_layernorm", f"{d}.input_layernorm"))
        out.update(_norm(sd, f"{b}.post_attention_layernorm", f"{d}.post_attention_layernorm"))
        for proj in ("q_proj", "k_proj", "v_proj"):
            out.update(_dense(sd, f"{b}.self_attn.{proj}", f"{d}.self_attn.{proj}",
                              bias=t.attention_bias))
        out.update(_dense(sd, f"{b}.self_attn.o_proj", f"{d}.self_attn.o_proj", bias=False))
        for proj in ("gate_proj", "up_proj", "down_proj"):
            out.update(_dense(sd, f"{b}.mlp.{proj}", f"{d}.mlp.{proj}", bias=False))
    if not t.tie_word_embeddings:
        head = "lm_head.weight" if "lm_head.weight" in sd else "language.embed_tokens.weight"
        out["text.lm_head.weight"] = _t(sd[head])
    return out


def convert_hf_state_dict(state_dict: Mapping[str, Any],
                          cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """An HF Qwen2.5-VL state dict (either layout) -> the port's state dict
    of the ViT and the decoder (no GlimpsePrune modules)."""
    sd = _strip_prefixes(state_dict)
    return {**convert_vision(sd, cfg), **convert_text(sd, cfg)}


_REQUIRED = object()


def _get(obj, name: str, default=_REQUIRED):
    """obj.name, or obj[name] for a dict (a config.json read with json)."""
    if isinstance(obj, Mapping):
        if name in obj:
            return obj[name]
    elif hasattr(obj, name):
        return getattr(obj, name)
    if default is _REQUIRED:
        raise KeyError(f"the HF config has no {name!r}")
    return default


def hf_config_to_model_config(hf_cfg, **gp_kwargs) -> ModelConfig:
    """The port's ModelConfig from an HF Qwen2_5_VLConfig, or from the
    dict of its config.json: an object with attributes or a mapping, the
    text fields in ``text_config`` or at the top level. transformers is
    never imported."""
    vc = _get(hf_cfg, "vision_config")
    tc = _get(hf_cfg, "text_config", hf_cfg)
    eos = _get(hf_cfg, "eos_token_id", None)
    return ModelConfig(
        vision=VisionConfig(
            depth=_get(vc, "depth"),
            hidden_size=_get(vc, "hidden_size"),
            intermediate_size=_get(vc, "intermediate_size"),
            num_heads=_get(vc, "num_heads"),
            in_channels=_get(vc, "in_channels", 3),
            patch_size=_get(vc, "patch_size"),
            spatial_merge_size=_get(vc, "spatial_merge_size"),
            temporal_patch_size=_get(vc, "temporal_patch_size"),
            window_size=_get(vc, "window_size"),
            fullatt_block_indexes=tuple(_get(vc, "fullatt_block_indexes")),
            out_hidden_size=_get(vc, "out_hidden_size"),
            hidden_act=_get(vc, "hidden_act", "silu"),
        ),
        text=TextConfig(
            vocab_size=_get(tc, "vocab_size"),
            hidden_size=_get(tc, "hidden_size"),
            intermediate_size=_get(tc, "intermediate_size"),
            num_hidden_layers=_get(tc, "num_hidden_layers"),
            num_attention_heads=_get(tc, "num_attention_heads"),
            num_key_value_heads=_get(tc, "num_key_value_heads"),
            hidden_act=_get(tc, "hidden_act"),
            rms_norm_eps=_get(tc, "rms_norm_eps"),
            rope_theta=_get(tc, "rope_theta"),
            mrope_section=tuple(_get(tc, "rope_scaling")["mrope_section"]),
            tie_word_embeddings=_get(hf_cfg, "tie_word_embeddings", False),
        ),
        gp=GPConfig(**gp_kwargs),
        image_token_id=_get(hf_cfg, "image_token_id"),
        video_token_id=_get(hf_cfg, "video_token_id"),
        vision_start_token_id=_get(hf_cfg, "vision_start_token_id"),
        vision_end_token_id=_get(hf_cfg, "vision_end_token_id"),
        eos_token_id=eos if isinstance(eos, int) else 151645,
        pad_token_id=_get(hf_cfg, "pad_token_id", None) or 151643,
    )

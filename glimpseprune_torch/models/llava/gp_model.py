"""LLaVA-1.5 + GlimpsePrune: CLIP tower + Llama decoder + GP modules.

Counterpart of glimpseprune_tpu/models/llava/gp_model.py
(``llama_text_config`` :33, ``CLIPTowerConfig`` :54, ``llava_config`` :80,
``Llava_GP`` :127 with ``vision_encode`` :189 and ``cdpruner_relevance``
:230). ``Llava_GP`` subclasses the port's ``Qwen2_5_VL_GP`` and replaces
only the vision side: the CLIP tower, the mlp2x_gelu projector
(``mm_projector_fc1`` / ``fc2``, exact GELU) and, with
``CLIPTowerConfig.with_text_tower``, CDPruner's CLIP text tower. Image
embeds leave ``vision_encode`` packed [B * G * G, H] with packed taps, so
the glimpse, the fuser, the keep policy, compaction, resume, the captured
decode and the continuous batcher are the inherited ones, as in JAX. The
Llama decoder is the port's ``TextDecoder`` with no qkv bias and 1-D rope:
one mRoPE section over identical position channels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from glimpseprune_torch.config import GPConfig, ModelConfig, TextConfig, VisionConfig
from glimpseprune_torch.models.layers import Linear
from glimpseprune_torch.models.llava.clip import CLIPTextTower, CLIPVisionTower
from glimpseprune_torch.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP


def llama_text_config(
    hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=32, vocab_size=32000,
    rms_norm_eps=1e-5, rope_theta=10000.0,
) -> TextConfig:
    head_dim = hidden_size // num_attention_heads
    return TextConfig(
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        intermediate_size=intermediate_size,
        num_hidden_layers=num_hidden_layers,
        num_attention_heads=num_attention_heads,
        num_key_value_heads=num_key_value_heads,
        rms_norm_eps=rms_norm_eps,
        rope_theta=rope_theta,
        mrope_section=(head_dim // 2,),  # 1-D rope
        attention_bias=False,
    )


@dataclass(frozen=True)
class CLIPTowerConfig:
    """CLIP ViT-L/14 at 336 (the defaults) and, with ``with_text_tower``,
    CDPruner's CLIP text tower and the projections into their shared
    embedding space."""

    depth: int = 24
    hidden_size: int = 1024
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 14
    image_size: int = 336
    feature_layer: int = -2
    with_text_tower: bool = False
    projection_dim: int = 768
    text_depth: int = 12
    text_hidden_size: int = 768
    text_num_heads: int = 12
    text_intermediate_size: int = 3072
    text_vocab_size: int = 49408
    text_max_positions: int = 77

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


def llava_config(clip: CLIPTowerConfig = CLIPTowerConfig(), text: Optional[TextConfig] = None,
                 gp: Optional[GPConfig] = None) -> ModelConfig:
    """ModelConfig for the LLaVA family: ``vision`` repeats the CLIP sizes
    that the fuser reads; the CLIP-only geometry stays in ``clip``."""
    text = text or llama_text_config()
    gp = gp or GPConfig(
        selected_layers=(21,),
        reduce_layer=21,
        selected_visual_layers=(22, 16, 10, 4),
        attn_fuse_size=256,
        visual_cond_size=512,
        attn_fuse_num_heads=4,
        attn_fuse_global=True,
        le_layers=tuple(range(text.num_hidden_layers)),
        le_length=1,
    )
    vision = VisionConfig(
        depth=clip.depth,
        hidden_size=clip.hidden_size,
        intermediate_size=clip.intermediate_size,
        num_heads=clip.num_heads,
        patch_size=clip.patch_size,
        spatial_merge_size=1,
        temporal_patch_size=1,
        out_hidden_size=text.hidden_size,
    )
    return ModelConfig(
        vision=vision,
        text=text,
        gp=gp,
        image_token_id=31999,   # any reserved id: embeds are overwritten
        video_token_id=31998,
        vision_start_token_id=31997,
        vision_end_token_id=31996,
        eos_token_id=2,
        pad_token_id=0,
        model_family="llava",
    )


def load_llava_config(directory: str, **clip_kwargs) -> Tuple[ModelConfig, CLIPTowerConfig]:
    """(ModelConfig from ``directory``/config.json, the CLIP tower's
    config: ``CLIPTowerConfig(**clip_kwargs)``), for example
    ``configs/model_llava1_5_7b_gp``. Raises unless the config is of the
    LLaVA family and its vision sizes are the tower's."""
    cfg = ModelConfig.load(directory)
    clip = CLIPTowerConfig(**clip_kwargs)
    if cfg.model_family != "llava":
        raise ValueError(f"{directory}: model_family is {cfg.model_family!r}, not 'llava'")
    v = cfg.vision
    have = (v.depth, v.hidden_size, v.intermediate_size, v.num_heads, v.patch_size)
    want = (clip.depth, clip.hidden_size, clip.intermediate_size, clip.num_heads,
            clip.patch_size)
    if have != want:
        raise ValueError(f"{directory}: vision sizes {have} are not the CLIP tower's {want}")
    return cfg, clip


class Llava_GP(Qwen2_5_VL_GP):
    """LLaVA GP model: CLIP and the projector in place of the Qwen ViT.
    ``vision_encode`` takes normalized pixels [B, S, S, 3] and returns the
    packed ([B * G * G, H_text], taps) buffers the inherited glimpse
    expects."""

    model_family = "llava"

    def __init__(self, cfg: ModelConfig, clip_cfg: Optional[CLIPTowerConfig] = None):
        self.clip_cfg = clip_cfg or CLIPTowerConfig()  # read by _init_vision
        super().__init__(cfg)

    def _init_vision(self) -> None:
        c, cc = self.cfg, self.clip_cfg
        self.visual = CLIPVisionTower(cc, tap_layers=c.gp.selected_visual_layers)
        if cc.with_text_tower:
            self.clip_text = CLIPTextTower(cc)
        self.mm_projector_fc1 = Linear(cc.hidden_size, c.text.hidden_size)
        self.mm_projector_fc2 = Linear(c.text.hidden_size, c.text.hidden_size)

    def _bind_vision(self, cfg: ModelConfig) -> None:
        """CLIP reads no knob of ``cfg.vision``: nothing to bind."""

    def vision_weight_tier(self, cfg: ModelConfig) -> str:
        """CLIP stays unquantized in every tier: JAX's DEFAULT_INCLUDE
        matches none of its kernels."""
        return "none"

    def vision_encode(self, patches, pos_ids=None, full_seg=None, vis_valid=None,
                      dense_attn: bool = False, emit_importance: bool = False):
        """pixels [B, S, S, 3] -> (packed projected embeds [B * N, H], taps
        [B * N, D] each[, importance]). The importance is (CLS attention,
        keys, CLS attention) packed [B * N, ...]: LLaVA VisionZip's
        dominant metric, and both of VScan's scans (JAX :189-226). The
        Qwen geometry arguments are accepted and ignored, so the runner
        calls both families alike."""
        if emit_importance:
            feats, taps, (cls_attn, keys_mean) = self.visual(patches, emit_importance=True)
        else:
            feats, taps = self.visual(patches)
        b, n, _ = feats.shape
        proj = self.mm_projector_fc2(F.gelu(self.mm_projector_fc1(feats)))
        packed = proj.reshape(b * n, -1)
        packed_taps = [t.reshape(b * n, -1) for t in taps]
        if emit_importance:
            imp = cls_attn.reshape(b * n)
            return packed, packed_taps, (imp, keys_mean.reshape(b * n, -1), imp)
        return packed, packed_taps

    def cdpruner_relevance(self, pixels: torch.Tensor, clip_text_ids: torch.Tensor,
                           text_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """CDPruner's query relevance (JAX :230-249): the negated mean cosine
        similarity of each CLIP-projected patch embed to the CLIP text
        embeds of the question's segments -> [B * N] fp32, packed.
        pixels [B, S, S, 3]; clip_text_ids [M, text_max_positions]
        zero-padded segments, shared by the batch."""
        if not self.clip_cfg.with_text_tower:
            raise ValueError("cdpruner_relevance needs the CLIP text tower: build the model "
                             "with CLIPTowerConfig(with_text_tower=True)")
        img = self.visual(pixels, emit_embeds=True)[-1].float()  # [B, N, C]
        txt = self.clip_text(clip_text_ids, text_valid).float()   # [M, C]
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True).clamp(min=1e-8)
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True).clamp(min=1e-8)
        return -(img @ txt.T).mean(-1).reshape(-1)

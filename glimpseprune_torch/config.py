"""Configuration dataclasses for GlimpsePrune-TPU.

A copy of glimpseprune_tpu/config.py, kept in the port so that the port
imports nothing of the JAX package; tests/test_torch_config.py holds the
two equal.

Mirrors the three-tier config scheme of the reference (SURVEY.md §5):
model config (all GP knobs; reference transformers_gp/models/qwen2_5_vl/
configuration.py:5-96), trainable-module persistence contract, and YAML
loading for training/eval. Plain dataclasses instead of HF PretrainedConfig:
they hash cleanly for jit static args and serialize to JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


def _tupled(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


@dataclass(frozen=True)
class VisionConfig:
    """Qwen2.5-VL-style windowed ViT geometry and sizes."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    hidden_act: str = "silu"
    # "none" | "int8": weight-only quantization of the block stack
    # (quantization.py; the analogue of the reference model loader's load_8bit)
    weight_quant: str = "none"
    # "none" | "int8" | "prefill": dynamic per-row activation quantization on
    # the int8 kernels -> the v5e native int8 MXU mode
    # (quantization.matmul_w8a8, 1.43x matmul throughput measured). Both
    # non-none values behave identically here (the ViT is prefill-only
    # compute). Requires weight_quant == "int8".
    act_quant: str = "none"
    # run QK^T inside the flash-attention kernel on the int8 MXU mode with
    # dynamic per-row q/k quantization (inference-only — the int8 kernel has
    # no vjp). Only takes effect where act_quant enables the W8A8 tier.
    attn_qk_int8: bool = False
    # extend the int8 kernel tier to the PV dot (static-1/127 p, per-column
    # v per tile); requires attn_qk_int8
    attn_pv_int8: bool = False

    def __post_init__(self):
        object.__setattr__(self, "fullatt_block_indexes", _tupled(self.fullatt_block_indexes))

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size * self.spatial_merge_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class TextConfig:
    """Qwen2.5 LLM decoder sizes + mRoPE sections."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    max_position_embeddings: int = 128000
    tie_word_embeddings: bool = False
    # Llama-family knobs: no qkv bias, plain 1-D rope (expressed as a single
    # mrope section spanning head_dim//2 with identical position channels)
    attention_bias: bool = True
    # "none" | "int8": weight-only quantization of the layer stack
    weight_quant: str = "none"
    # "none" | "int8" | "prefill": dynamic W8A8 tier (see
    # VisionConfig.act_quant). "prefill" = W8A8 in prefill layers only,
    # decode stays weight-only (decode is HBM-bound; the int8 MXU mode buys
    # nothing there) — the serving default.
    act_quant: str = "none"
    # int8-QK flash attention in prefill (see VisionConfig.attn_qk_int8);
    # inference-only, gated on act_quant being active for the prefill path
    attn_qk_int8: bool = False
    # extend to the PV dot too (see VisionConfig.attn_pv_int8)
    attn_pv_int8: bool = False
    # decode KV cache dtype tier: "none" = model dtype (bf16), "int8" =
    # per-(token, head) symmetric int8 + f32 amax/127 scales (the cache
    # becomes the pytree {"q": int8 [L,B,T,Hkv,D], "s": f32 [L,B,T,Hkv]}).
    # Cache residency caps the feasible serving batch on a 16 GB chip
    # (0.94 GB/row at 16k ctx, 7B bf16) — int8 halves it; prefill attention
    # stays full-precision, quantization happens at cache build/append
    kv_cache_quant: str = "none"
    # rematerialize decoder layers in the backward pass (training-memory
    # knob; inference cost is zero — remat only changes the VJP)
    remat: bool = False
    # >0 declares in-scan LoRA slots on every decoder linear (GRPO policy
    # model; see training/lora.insert_lora)
    lora_rank: int = 0

    def __post_init__(self):
        object.__setattr__(self, "mrope_section", _tupled(self.mrope_section))

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class GPConfig:
    """GlimpsePrune knobs.

    Field-for-field parity with the reference's 22 GP config knobs
    (reference transformers_gp/models/qwen2_5_vl/configuration.py:29-50),
    plus TPU-specific static-shape budgets (`keep_budget`).
    """

    # which decoder layers' glimpse-attention rows feed the fuser
    selected_layers: Tuple[int, ...] = ()
    # harvest raw q@K^T logits (True) or masked log-softmax rows (False)
    use_attention_logits: bool = False
    # fuser family + sizes
    attn_fuse_type: str = "AttnFuserV1"
    attn_fuse_size: int = 256
    attn_fuse_num_heads: int = 4
    attn_fuse_hidden_act: str = "silu"
    attn_fuse_global: bool = False
    # which ViT layers provide conditioning features
    selected_visual_layers: Tuple[int, ...] = (8,)
    visual_cond_size: int = 256
    # prepend normalized raw-attention map as layer-0 logits at eval
    ori_attn_supervision: bool = True
    # emit one logit map per fuser layer during training
    deep_supervision: bool = True
    # learnable glimpse embeddings
    le_layers: Tuple[int, ...] = (0,)
    le_length: int = 1
    le_dropout_prob: float = 0.0
    le_norm_type: str = "rmsnorm"
    # keep-policy
    reduce_threshold: float = 0.5
    reduce_layer: int = 1000
    anchor_positions: Tuple[str, ...] = ()
    min_remain_num: Optional[int] = 1
    max_remain_ratio: Optional[float] = None
    # oracle / ablation modes (SURVEY.md §4: correctness probes)
    use_ref_masks: bool = False
    use_zero_masks: bool = False
    # --- TPU-native additions -------------------------------------------
    # Static surviving-token budget per sequence. None -> derived from
    # max_remain_ratio at call time; pruned prefill output buffers are
    # [B, L_text + keep_budget] regardless of how many tokens pass the
    # threshold (replaces data-dependent shapes of reference
    # model_gp.py:1552-1659).
    keep_budget: Optional[int] = None
    # Extension (NOT reference semantics): apply threshold/cap/floor per
    # image instead of per row on multi-image rows. The reference's
    # _get_remain_masks (model_gp.py:1495-1549) iterates per BATCH ROW with
    # all images' logits concatenated, so cap/floor budgets span the whole
    # row — executably verified by tests/test_reference_differential.py.
    # True gives each image its own balanced budget.
    per_image_policy: bool = False

    def __post_init__(self):
        object.__setattr__(self, "selected_layers", _tupled(self.selected_layers) or ())
        object.__setattr__(self, "selected_visual_layers", _tupled(self.selected_visual_layers) or ())
        object.__setattr__(self, "le_layers", _tupled(self.le_layers) or ())
        object.__setattr__(self, "anchor_positions", _tupled(self.anchor_positions) or ())

    @property
    def has_le(self) -> bool:
        return len(self.le_layers) > 0 and self.le_length > 0


@dataclass(frozen=True)
class ModelConfig:
    """Full GP-LVLM config: vision tower + LLM + GP knobs + special tokens."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    gp: GPConfig = field(default_factory=GPConfig)
    # special token ids (Qwen2.5-VL defaults)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    eos_token_id: int = 151645
    pad_token_id: int = 151643
    model_family: str = "qwen2_5_vl"

    def validate(self):
        ngp = self.gp
        nlayers = self.text.num_hidden_layers
        if ngp.le_layers and max(ngp.le_layers) >= nlayers:
            raise ValueError(
                f"le_layers {ngp.le_layers} must be < num_hidden_layers {nlayers}"
            )
        if ngp.selected_layers and max(ngp.selected_layers) > ngp.reduce_layer:
            raise ValueError(
                f"selected_layers {ngp.selected_layers} must be <= reduce_layer {ngp.reduce_layer}"
            )
        for a in ngp.anchor_positions:
            if a not in ("tl", "tr", "bl", "br"):
                raise ValueError(f"Unknown anchor position {a!r} (want tl/tr/bl/br)")
        qk = ngp.attn_fuse_size + (
            ngp.visual_cond_size if ngp.selected_visual_layers else 0
        )
        if qk % ngp.attn_fuse_num_heads != 0:
            raise ValueError(
                f"attn_fuse_size+visual_cond_size ({qk}) must be divisible by "
                f"attn_fuse_num_heads ({ngp.attn_fuse_num_heads})"
            )
        return self

    # ---- (de)serialization ----------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        d = dict(d)
        vision = VisionConfig(**d.pop("vision", {}))
        text = TextConfig(**d.pop("text", {}))
        gp = GPConfig(**d.pop("gp", {}))
        return cls(vision=vision, text=text, gp=gp, **d)

    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, directory: str) -> "ModelConfig":
        with open(os.path.join(directory, "config.json")) as f:
            return cls.from_dict(json.load(f))

    def replace_gp(self, **kwargs) -> "ModelConfig":
        """Runtime GP-knob overrides (reference eval wrapper
        viscot_eval/models/qwen2_5_vl_gp.py:47-59 mutates config post-load)."""
        return dataclasses.replace(self, gp=dataclasses.replace(self.gp, **kwargs))


def load_yaml_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


# ---- canonical sizes -----------------------------------------------------

def qwen2_5_vl_3b() -> ModelConfig:
    return ModelConfig(
        vision=VisionConfig(out_hidden_size=2048),
        text=TextConfig(
            vocab_size=151936,
            hidden_size=2048,
            intermediate_size=11008,
            num_hidden_layers=36,
            num_attention_heads=16,
            num_key_value_heads=2,
        ),
    )


def qwen2_5_vl_7b() -> ModelConfig:
    return ModelConfig()


def tiny_test_config(**gp_kwargs) -> ModelConfig:
    """Small config for unit tests / CI parity runs vs HF CPU."""
    return ModelConfig(
        vision=VisionConfig(
            depth=4,
            hidden_size=32,
            intermediate_size=64,
            num_heads=4,
            patch_size=14,
            window_size=56,
            fullatt_block_indexes=(3,),
            out_hidden_size=64,
        ),
        text=TextConfig(
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=4,
            num_attention_heads=4,
            num_key_value_heads=2,
            mrope_section=(2, 3, 3),
        ),
        gp=GPConfig(
            selected_layers=(1,),
            reduce_layer=1,
            selected_visual_layers=(3, 1),
            attn_fuse_size=16,
            visual_cond_size=16,
            attn_fuse_num_heads=4,
            le_layers=(0, 1, 2, 3),
            le_length=1,
            max_remain_ratio=0.5,
            **gp_kwargs,
        ),
        image_token_id=500,
        video_token_id=501,
        vision_start_token_id=498,
        vision_end_token_id=499,
        eos_token_id=502,
        pad_token_id=0,
    )

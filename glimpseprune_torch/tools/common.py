"""What the port's command lines share: the model source, the device, the
tokenizer and config files.

A model comes from exactly one of three sources:

- ``--hf-model DIR``: an HF Qwen2.5-VL checkpoint through the port's
  converter (``models/qwen2_5_vl/convert.py``), the GlimpsePrune modules
  drawn from ``--seed``; transformers is imported only here;
- ``--full-params DIR``: a checkpoint written by
  ``persistence.save_full_params`` (any weight tier);
- ``--model-config DIR --seed N``: random weights at the config's full
  width (``convert.init_random``), e.g. ``configs/model_qwen2_5_7b_gp``.

``--new-modules DIR`` then loads trained GlimpsePrune modules
(``persistence.load_new_modules``, the reference release's
``new_modules_gp.pt`` layout) and takes the GlimpsePrune knobs of the
config saved beside them. Everything runs on ``--device`` (default
``cuda``, in bf16; ``cpu`` in fp32); without a card the entry points raise
unless the caller passes ``--device cpu``. The command lines run the
Qwen2.5-VL family, whose input prep the harness uses.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from glimpseprune_torch.config import ModelConfig, load_yaml_config


def add_model_args(ap: argparse.ArgumentParser, default_config: Optional[str] = None) -> None:
    """The model source and device arguments; with ``default_config`` no
    source is required and ``--model-config`` defaults to it."""
    src = ap.add_mutually_exclusive_group(required=default_config is None)
    src.add_argument("--hf-model", default=None, help="HF Qwen2.5-VL checkpoint directory")
    src.add_argument("--full-params", default=None,
                     help="directory written by persistence.save_full_params")
    src.add_argument("--model-config", default=default_config,
                     help="config directory (config.json): random weights from --seed")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (--model-config) or of the "
                    "GlimpsePrune modules drawn around HF weights (--hf-model)")
    ap.add_argument("--new-modules", default=None,
                    help="directory holding new_modules_gp.pt and its config.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; bf16 weights) or cpu (fp32 weights)")


def resolve_device(name: str) -> torch.device:
    """The entry points' device; a CUDA device without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA card is available "
                         "(pass --device cpu to run on the CPU)")
    return dev


def read_config(path: Optional[str]) -> Dict[str, Any]:
    """A config file as a dict: ``.json`` with json, anything else as YAML."""
    if not path:
        return {}
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    return load_yaml_config(path) or {}


class StandInTokenizer:
    """Ordinary text ids without a vocabulary, for models that have no HF
    tokenizer (random weights): one id a word, ``lo + crc32(word) % (hi -
    lo)`` with lo = 5 and hi the lowest special id at or above it (or the
    vocabulary's end), so no id is a special token. It plays the part of
    the JAX demo's ``TinyTok``; ``decode`` writes the ids."""

    LO = 5

    def __init__(self, cfg: ModelConfig):
        specials = [cfg.image_token_id, cfg.video_token_id, cfg.vision_start_token_id,
                    cfg.vision_end_token_id, cfg.eos_token_id, cfg.pad_token_id]
        self.hi = min([cfg.text.vocab_size] + [i for i in specials if i >= self.LO])

    def __call__(self, text: str) -> List[int]:
        return [self.LO + zlib.crc32(w.encode()) % (self.hi - self.LO) for w in text.split()]

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self(text)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return " ".join(str(int(i)) for i in ids)


def _hf_model(hf_dir: str, seed: int, device, dtype) -> Tuple[ModelConfig, torch.nn.Module, Any]:
    from transformers import AutoTokenizer, Qwen2_5_VLForConditionalGeneration

    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.convert import (
        convert_hf_state_dict,
        hf_config_to_model_config,
    )

    with open(os.path.join(hf_dir, "config.json")) as f:
        cfg = hf_config_to_model_config(json.load(f))
    hf = Qwen2_5_VLForConditionalGeneration.from_pretrained(hf_dir, torch_dtype=dtype)
    model = init_random(cfg, seed, device, dtype, base=convert_hf_state_dict(hf.state_dict(), cfg))
    return cfg, model, AutoTokenizer.from_pretrained(hf_dir)


def load_model(args: argparse.Namespace, gp_overrides: Optional[Dict[str, Any]] = None
               ) -> Tuple[ModelConfig, torch.nn.Module, Any]:
    """(config, model bound to it, tokenizer) from the parsed model
    arguments; ``gp_overrides`` replace GlimpsePrune knobs last."""
    from glimpseprune_torch.persistence import load_full_params, load_new_modules

    from glimpseprune_torch.convert import init_random

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    tok = None
    if args.hf_model:
        cfg, model, tok = _hf_model(args.hf_model, args.seed, dev, dtype)
    elif args.full_params:
        model, cfg = load_full_params(args.full_params, device=dev)
    else:
        cfg = ModelConfig.load(args.model_config)
        if cfg.model_family != "qwen2_5_vl":
            raise SystemExit(f"{args.model_config}: model_family {cfg.model_family!r}; the "
                             "command lines run qwen2_5_vl models")
        model = init_random(cfg, args.seed, dev, dtype)
    if args.new_modules:
        model, saved = load_new_modules(model, args.new_modules)
        cfg = dataclasses.replace(cfg, gp=saved.gp)
    if gp_overrides:
        cfg = cfg.replace_gp(**gp_overrides)
    model.set_config(cfg)
    return cfg, model, tok or StandInTokenizer(cfg)


def text_codec(tok):
    """(tokenize, detokenize) over a tokenizer: plain text ids, no special
    tokens added."""
    return (lambda text: list(tok.encode(text, add_special_tokens=False)),
            lambda ids: tok.decode(list(ids), skip_special_tokens=True))


# ---- what the profilers share

DEFAULT_CONFIG = "configs/model_qwen2_5_7b_gp"
# the serving tiers (bench.py:869-878): int8 = int8 weights, W8A8 prefill,
# int8 KV; int4 = int4 weights, W4A8 prefill, int8 ViT attention, int8 KV
QUANT_TIERS = {
    "int8": dict(act_quant="prefill"),
    "int4": dict(act_quant="prefill", attn_qk_int8="vision", attn_pv_int8="vision"),
}


def add_profile_args(ap: argparse.ArgumentParser, quant_default: str = "") -> None:
    """The model source (``--model-config`` defaults to the 7B config),
    ``--scale tiny`` (the tiny test config, for the CPU), ``--quant``, and
    ``--json`` (end with one JSON line)."""
    add_model_args(ap, default_config=DEFAULT_CONFIG)
    ap.add_argument("--scale", default="full", choices=["full", "tiny"],
                    help="full: the model source's width; tiny: the tiny test config")
    ap.add_argument("--quant", default=quant_default, choices=["", "int8", "int4"],
                    help="weight tier: int8 (the bench's: W8A8 prefill, int8 KV) or int4")
    ap.add_argument("--json", action="store_true", help="end with one JSON line")


def bench_config(scale: str, reduce_layer_override: Optional[int] = None) -> ModelConfig:
    """The bench's model configs (copy of ``bench.build_cfg``): "1b", "3b"
    and "7b" with the reference's 3B GlimpsePrune recipe (AttnFuserV1 of
    256 with a 512 visual condition over ViT layers 31, 23, 15, 7, attention
    logits harvested, a cap of 0.08, no ori-attention supervision), its
    harvest layer moved to 18 of 28 (7b) or 15 of 24 (1b); "tiny" is
    ``tiny_test_config()``. ``reduce_layer_override`` moves the reduce
    layer (the harvest layer to at most it). Not
    ``configs/model_qwen2_5_7b_gp``, which keeps the reference 7B recipe."""
    from glimpseprune_torch.config import GPConfig, TextConfig, VisionConfig, tiny_test_config

    if scale == "tiny":
        cfg = tiny_test_config()
        text, vision, gp = cfg.text, cfg.vision, cfg.gp
    else:
        gp = GPConfig(selected_layers=(23,), reduce_layer=23, use_attention_logits=True,
                      attn_fuse_type="AttnFuserV1", attn_fuse_size=256, visual_cond_size=512,
                      attn_fuse_num_heads=4, selected_visual_layers=(31, 23, 15, 7),
                      le_layers=tuple(range(36)), le_length=1, max_remain_ratio=0.08,
                      min_remain_num=1, ori_attn_supervision=False)
    if scale == "7b":
        text = TextConfig(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                          num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4)
        vision = VisionConfig(out_hidden_size=3584)
        gp = dataclasses.replace(gp, selected_layers=(18,), reduce_layer=18,
                                 le_layers=tuple(range(28)))
    elif scale == "3b":
        text = TextConfig(vocab_size=151936, hidden_size=2048, intermediate_size=11008,
                          num_hidden_layers=36, num_attention_heads=16, num_key_value_heads=2)
        vision = VisionConfig(out_hidden_size=2048)
    elif scale == "1b":
        text = TextConfig(vocab_size=151936, hidden_size=1536, intermediate_size=8192,
                          num_hidden_layers=24, num_attention_heads=12, num_key_value_heads=2,
                          mrope_section=(16, 24, 24), hidden_act="silu")
        vision = VisionConfig(out_hidden_size=1536)
        gp = dataclasses.replace(gp, selected_layers=(15,), reduce_layer=15,
                                 le_layers=tuple(range(24)))
    elif scale != "tiny":
        raise ValueError(scale)
    if reduce_layer_override is not None:
        gp = dataclasses.replace(gp, reduce_layer=reduce_layer_override,
                                 selected_layers=(min(gp.selected_layers[0],
                                                      reduce_layer_override),))
    base = tiny_test_config() if scale == "tiny" else ModelConfig()
    return dataclasses.replace(base, vision=vision, text=text, gp=gp)


def depth_cut(cfg: ModelConfig, layers: int) -> ModelConfig:
    """cfg with its decoder cut to ``layers`` layers at full width: the
    glimpse embeddings of the layers kept, the harvest and reduce layers
    unchanged (they must lie below the cut). A run's budget of seconds cuts
    the depth, never the widths."""
    if not cfg.gp.reduce_layer < layers - 1:
        raise ValueError(f"a cut to {layers} layers leaves no layer after the reduce layer")
    gp = dataclasses.replace(cfg.gp, le_layers=tuple(l for l in cfg.gp.le_layers if l < layers))
    return dataclasses.replace(cfg, gp=gp, text=dataclasses.replace(
        cfg.text, num_hidden_layers=layers))


def tier_config(cfg: ModelConfig, quant: str, kv_quant: Optional[str] = None,
                weights_only: bool = False) -> ModelConfig:
    """cfg in a QUANT_TIERS tier ("" leaves the weights; ``weights_only``:
    the quantized weights alone, as the JAX training profilers take them);
    kv_quant (None: the tier's, int8 for a quantized tier) sets the KV
    cache tier."""
    from glimpseprune_torch.quantization import quantized_config

    if quant:
        cfg = quantized_config(cfg, quant, **({} if weights_only else QUANT_TIERS[quant]))
    kv = ("int8" if quant else "") if kv_quant is None else kv_quant
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                             kv_cache_quant=kv or "none"))


def profile_model(args: argparse.Namespace, quant: str = "", kv_quant: Optional[str] = None,
                  cfg_edit: Optional[Callable[[ModelConfig], ModelConfig]] = None,
                  weights_only: bool = False
                  ) -> Tuple[ModelConfig, torch.nn.Module, torch.device]:
    """(config, model bound to it, device) for a profiler. Random weights
    (``--model-config`` or ``--scale tiny``) in a quantized tier are drawn
    straight into it (``utils/fastinit.device_random_params``: no bf16
    copy); any other source loads through ``load_model`` and is quantized
    in place. ``cfg_edit`` changes the config before the model is bound."""
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.quantization import quantize_model
    from glimpseprune_torch.utils.fastinit import device_random_params

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    edit = cfg_edit or (lambda c: c)
    random_weights = (args.scale == "tiny" or (args.model_config and not args.hf_model
                                               and not args.full_params))
    if random_weights and not args.new_modules:
        base = tiny_test_config() if args.scale == "tiny" else ModelConfig.load(args.model_config)
        cfg = edit(tier_config(base, quant, kv_quant, weights_only))
        model = (device_random_params(cfg, args.seed, dev, dtype) if quant
                 else init_random(cfg, args.seed, dev, dtype))
        return cfg, model.set_config(cfg), dev
    cfg, model, _ = load_model(args)
    qcfg = edit(tier_config(cfg, quant, kv_quant, weights_only))
    if quant:
        quantize_model(model, quant, cfg=qcfg)
    return qcfg, model.set_config(qcfg), dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn: Callable[[], Any], dev: torch.device, iters: int = 3,
            warmup: int = 1) -> float:
    """The median ms of ``iters`` calls of fn after ``warmup`` calls: CUDA
    events on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(dev)
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev: torch.device) -> Optional[float]:
    """``max_memory_allocated`` since ``reset_peak`` in GiB (None on the CPU)."""
    if dev.type != "cuda":
        return None
    sync(dev)
    return torch.cuda.max_memory_allocated(dev) / 2**30


def text_ids(cfg: ModelConfig, rng, n: int) -> List[int]:
    """n ordinary text ids (the stand-in tokenizer's range: no special id)."""
    tok = StandInTokenizer(cfg)
    return [int(x) for x in rng.integers(tok.LO, min(tok.hi, 100000), n)]


def emit(record: Dict[str, Any], as_json: bool) -> Dict[str, Any]:
    if as_json:
        print(json.dumps(record))
    return record


def base_checksum(model: torch.nn.Module) -> str:
    """A checksum of the frozen base's bytes: every state-dict tensor
    outside the GlimpsePrune modules and the LoRA adapters, each viewed as
    bytes b_i and summed exactly on its own device as (sum b_i, sum (i mod
    65521 + 1) b_i) in int64, the pairs hashed in state-dict order. Two
    models of the same tiers and layout agree iff (up to a collision)
    their frozen tensors hold the same bytes."""
    from glimpseprune_torch.training.train_step import new_module_filter

    chunk = 1 << 24
    sums = []
    for name, t in model.state_dict().items():
        if new_module_filter(name) or "lora_" in name.rsplit(".", 1)[-1]:
            continue
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        s1 = torch.zeros((), dtype=torch.int64, device=b.device)
        s2 = torch.zeros((), dtype=torch.int64, device=b.device)
        for i in range(0, b.numel(), chunk):
            c = b[i:i + chunk].to(torch.int64)
            w = torch.arange(i, i + c.numel(), dtype=torch.int64, device=b.device) % 65521 + 1
            s1 += c.sum()
            s2 += (c * w).sum()
        sums.append((name, s1, s2))
    words = ";".join(f"{name}:{int(s1)}:{int(s2)}" for name, s1, s2 in sums)
    return hashlib.sha256(words.encode()).hexdigest()[:16]

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
import json
import os
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from glimpseprune_torch.config import ModelConfig, load_yaml_config


def add_model_args(ap: argparse.ArgumentParser) -> None:
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf-model", default=None, help="HF Qwen2.5-VL checkpoint directory")
    src.add_argument("--full-params", default=None,
                     help="directory written by persistence.save_full_params")
    src.add_argument("--model-config", default=None,
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

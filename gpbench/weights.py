"""Random weights from a seed, drawn on the card, in the HF Qwen2.5-VL
layout, plus the GlimpsePrune modules.

Both sides of a run take these tensors: the program through its HF
converter, the reference as they are. ``draw`` makes the same bits from the
same seed, so the reference draws them again after the program is freed
instead of keeping a second copy alive through the window.

Scales follow a lecun-normal init: matrices normal / sqrt(fan_in), the
embedding normal / sqrt(hidden), the glimpse embeddings normal * 0.02,
biases normal * 0.02 and norm scales 1 + normal * 0.05 (so that a dropped
bias or norm scale shows). The draws are grouped into a few large calls:
one per ViT block's and decoder layer's matrices, one for the embedding,
the head, the merger and the GlimpsePrune matrices, one for every bias and
one for every norm scale; each tensor is a view of its group. A group of
matrices that the program quantizes is freed once its views are gone.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Shapes = List[Tuple[str, Tuple[int, ...]]]
FUSER_OUT_BIAS = 3.0  # the deciding keep head's bias (see ``draw``)


def _vision_shapes(v: dict, out_hidden: int):
    h, i = v["hidden_size"], v["intermediate_size"]
    mu = v["spatial_merge_size"] ** 2
    groups, biases, norms = [], [], []
    groups.append([("visual.patch_embed.proj.weight",
                    (h, v["in_channels"], v["temporal_patch_size"], v["patch_size"],
                     v["patch_size"]))])
    for b in range(v["depth"]):
        p = f"visual.blocks.{b}"
        groups.append([(f"{p}.attn.qkv.weight", (3 * h, h)), (f"{p}.attn.proj.weight", (h, h)),
                       (f"{p}.mlp.gate_proj.weight", (i, h)), (f"{p}.mlp.up_proj.weight", (i, h)),
                       (f"{p}.mlp.down_proj.weight", (h, i))])
        biases += [(f"{p}.attn.qkv.bias", (3 * h,)), (f"{p}.attn.proj.bias", (h,)),
                   (f"{p}.mlp.gate_proj.bias", (i,)), (f"{p}.mlp.up_proj.bias", (i,)),
                   (f"{p}.mlp.down_proj.bias", (h,))]
        norms += [(f"{p}.norm1.weight", (h,)), (f"{p}.norm2.weight", (h,))]
    groups.append([("visual.merger.mlp.0.weight", (mu * h, mu * h)),
                   ("visual.merger.mlp.2.weight", (out_hidden, mu * h))])
    biases += [("visual.merger.mlp.0.bias", (mu * h,)), ("visual.merger.mlp.2.bias", (out_hidden,))]
    norms.append(("visual.merger.ln_q.weight", (h,)))
    return groups, biases, norms


def _text_shapes(t: dict):
    h, i, v = t["hidden_size"], t["intermediate_size"], t["vocab_size"]
    d = h // t["num_attention_heads"]
    dq, dkv = t["num_attention_heads"] * d, t["num_key_value_heads"] * d
    groups, biases, norms = [[("model.embed_tokens.weight", (v, h))]], [], []
    for l in range(t["num_hidden_layers"]):
        p = f"model.layers.{l}"
        groups.append([(f"{p}.self_attn.q_proj.weight", (dq, h)),
                       (f"{p}.self_attn.k_proj.weight", (dkv, h)),
                       (f"{p}.self_attn.v_proj.weight", (dkv, h)),
                       (f"{p}.self_attn.o_proj.weight", (h, dq)),
                       (f"{p}.mlp.gate_proj.weight", (i, h)), (f"{p}.mlp.up_proj.weight", (i, h)),
                       (f"{p}.mlp.down_proj.weight", (h, i))])
        if t.get("attention_bias", True):
            biases += [(f"{p}.self_attn.q_proj.bias", (dq,)),
                       (f"{p}.self_attn.k_proj.bias", (dkv,)),
                       (f"{p}.self_attn.v_proj.bias", (dkv,))]
        norms += [(f"{p}.input_layernorm.weight", (h,)),
                  (f"{p}.post_attention_layernorm.weight", (h,))]
    norms.append(("model.norm.weight", (h,)))
    if not t.get("tie_word_embeddings", False):
        groups.append([("lm_head.weight", (v, h))])
    return groups, biases, norms


def _gp_shapes(model: dict):
    """The GlimpsePrune modules under the names the program's state dict
    gives them (AttnFuserV1 with deep supervision, rmsnorm glimpse norm)."""
    v, t, gp = model["vision"], model["text"], model["gp"]
    h = t["hidden_size"]
    fs, cond, heads = gp["attn_fuse_size"], gp["visual_cond_size"], gp["attn_fuse_num_heads"]
    n_vis = len(gp["selected_visual_layers"])
    n_in = len(gp["selected_layers"]) * t["num_attention_heads"]
    qk = fs + cond
    if gp["attn_fuse_type"] != "AttnFuserV1" or not gp.get("deep_supervision", True):
        raise ValueError("the harness draws the AttnFuserV1 modules with deep supervision only")
    if qk % heads:
        raise ValueError("attn_fuse_size + visual_cond_size must divide by the heads")
    mats, biases, norms = [], [], []
    f = "attn_fuser"
    mats.append((f"{f}.attn_in_proj.weight", (fs, n_in)))
    biases.append((f"{f}.attn_in_proj.bias", (fs,)))
    for i in range(n_vis):
        mats.append((f"{f}.cond_in_projs.{i}.weight", (cond, v["hidden_size"])))
        biases.append((f"{f}.cond_in_projs.{i}.bias", (cond,)))
    for i in range(n_vis):
        p = f"{f}.layers.{i}"
        mats += [(f"{p}.attn.q_proj.weight", (qk, qk)), (f"{p}.attn.k_proj.weight", (qk, qk)),
                 (f"{p}.attn.v_proj.weight", (fs, fs)), (f"{p}.attn.o_proj.weight", (fs, fs)),
                 (f"{p}.mlp.gate_proj.weight", (2 * fs, fs)),
                 (f"{p}.mlp.up_proj.weight", (2 * fs, fs)),
                 (f"{p}.mlp.down_proj.weight", (fs, 2 * fs))]
        biases += [(f"{p}.mlp.gate_proj.bias", (2 * fs,)), (f"{p}.mlp.up_proj.bias", (2 * fs,)),
                   (f"{p}.mlp.down_proj.bias", (fs,))]
        norms += [(f"{p}.norm1.weight", (fs,)), (f"{p}.norm2.weight", (fs,))]
    for i in range(n_vis):
        mats.append((f"{f}.attn_out_projs.{i}.weight", (1, fs)))
        biases.append((f"{f}.attn_out_projs.{i}.bias", (1,)))
    mats.append(("le_proj.weight", (h, h)))
    biases.append(("le_proj.bias", (h,)))
    if gp.get("le_norm_type", "rmsnorm") != "rmsnorm":
        raise ValueError("the harness draws the rmsnorm glimpse norm only")
    norms.append(("le_norm.weight", (h,)))
    le = [("learnable_embeddings", (len(gp["le_layers"]), gp["le_length"], h))]
    return [mats], biases, norms, le


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _fill(shapes: Shapes, gen, device, dtype, scale_of) -> Dict[str, torch.Tensor]:
    """One normal draw for the group, each tensor a scaled view of it."""
    flat = torch.randn(sum(_numel(s) for _, s in shapes), generator=gen, device=device,
                       dtype=dtype)
    out, at = {}, 0
    for name, shape in shapes:
        n = _numel(shape)
        out[name] = flat[at:at + n].view(shape).mul_(scale_of(name, shape))
        at += n
    return out


def _fan_in_scale(name, shape) -> float:
    if name.endswith("embed_tokens.weight"):
        return shape[1] ** -0.5
    return _numel(shape[1:]) ** -0.5


def draw(model: dict, seed: int, device, dtype=torch.bfloat16):
    """(HF-layout state dict, GlimpsePrune state dict) of random weights
    from ``seed`` on ``device`` in ``dtype``; the same seed gives the same
    bits. ``model`` is a configuration file's ``model`` section.

    The random fuser is shaped so that the recipe's cap, and not the sign
    of a random offset, decides how many image tokens a request keeps: each
    row of the harvest's input projection is centred (a constant shift of
    the harvested rows, such as the log-softmax's -log S, then moves
    nothing), and the deciding head's bias is ``FUSER_OUT_BIAS`` (every
    token above the threshold, the cap binding, the logits far from
    saturation)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    vg, vb, vn = _vision_shapes(model["vision"], model["vision"]["out_hidden_size"])
    tg, tb, tn = _text_shapes(model["text"])
    gg, gb, gn, le = _gp_shapes(model)
    hf, gp = {}, {}
    for group in vg + tg:
        hf.update(_fill(group, gen, device, dtype, _fan_in_scale))
    for group in gg:
        gp.update(_fill(group, gen, device, dtype, _fan_in_scale))
    gp.update(_fill(le, gen, device, dtype, lambda n, s: 0.02))
    bias = _fill(vb + tb + gb, gen, device, dtype, lambda n, s: 0.02)
    norm = _fill(vn + tn + gn, gen, device, dtype, lambda n, s: 0.05)
    for name, t in norm.items():
        t.add_(1.0)
    w_in = gp["attn_fuser.attn_in_proj.weight"]
    w_in.sub_(w_in.float().mean(1, keepdim=True).to(dtype))
    last = len(model["gp"]["selected_visual_layers"]) - 1
    bias[f"attn_fuser.attn_out_projs.{last}.bias"].fill_(FUSER_OUT_BIAS)
    gp_names = {name for name, _ in gb + gn}
    for part in (bias, norm):
        for name, t in part.items():
            (gp if name in gp_names else hf)[name] = t
    return hf, gp

"""Operations and bytes of the model's work and of the attention kernels
K1 and K2, with the published peaks of one NVIDIA H100 SXM (dense rates).

Frozen arithmetic: a kernel's bound is max(operations over the peak of the
precision it computes in, bytes over the memory bandwidth), counting each
input byte read once and each output byte written once, and only the
(query, key) pairs that the inputs allow. K1 and K2 follow the kernel
table of PERF.md (K1 at qkv [65536, 3, 16, 80]: 0.2066 ms by bytes; dense
K2 at [1, 16, 65536, 80]: 22.2348 ms by operations).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
BF16, INT32, BOOL = 2, 4, 1


def bound_s(flops: float = 0.0, nbytes: float = 0.0, int8_ops: float = 0.0) -> float:
    """The least seconds the card can take for the work."""
    return max(flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES)


def k1_call(p: int, heads: int, d: int, wp: int) -> Tuple[float, float]:
    """(flops, bytes) of K1 over qkv [p, 3, heads, d] in full windows of wp
    patches: qkv, cos, sin and the valid mask read, the output written."""
    flops = 4.0 * (p // wp) * wp * wp * heads * d
    nbytes = p * 3 * heads * d * BF16 + 2 * p * d * BF16 + p * BOOL + p * heads * d * BF16
    return flops, nbytes


def k2_call(hq: int, hkv: int, s: int, dqk: int, dv: int, pairs: int,
            segments: bool) -> Tuple[float, float]:
    """(flops, bytes) of K2 with batch 1: q [hq, s, dqk], k [hkv, s, dqk], v
    [hkv, s, dv], out [hq, s, dv], the segment ids of q and kv (int32 [s])
    where given; ``pairs`` allowed (query, key) pairs, every head."""
    flops = 2.0 * pairs * hq * (dqk + dv)
    nbytes = (hq * s * dqk + hkv * s * dqk + hkv * s * dv + hq * s * dv) * BF16
    return flops, nbytes + (2 * s * INT32 if segments else 0)


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def attention_calls(model: dict, shape: dict) -> Dict[str, List[Tuple[float, float]]]:
    """{"K1": [(flops, bytes)], "K2": [...]} of one pruned prefill: the
    windowed ViT blocks (K1), the full-attention blocks (dense K2), the
    decoder layers to the reduce layer over the whole row and the rest over
    the kept row (causal K2 with segment ids), the fuser's layers (K2 with
    segment ids). ``shape``: patches ``p``, image tokens ``n_img``, the
    row's slots ``s_pad`` and valid tokens ``s_valid``, the kept row's slots
    ``r_pad`` and valid tokens ``r_valid``."""
    v, t, g = model["vision"], model["text"], model["gp"]
    vh = v["num_heads"]
    vd = v["hidden_size"] // vh
    win = v["window_size"] // v["spatial_merge_size"] // v["patch_size"]
    wp = win * win * v["spatial_merge_size"] ** 2
    p = shape["p"]
    full = len(v["fullatt_block_indexes"])
    calls = {"K1": [k1_call(p, vh, vd, wp)] * (v["depth"] - full),
             "K2": [k2_call(vh, vh, p, vd, vd, p * p, False)] * full}
    hq, hkv = t["num_attention_heads"], t["num_key_value_heads"]
    d = t["hidden_size"] // hq
    red = min(g["reduce_layer"], t["num_hidden_layers"] - 1)
    calls["K2"] += [k2_call(hq, hkv, shape["s_pad"], d, d, causal_pairs(shape["s_valid"]),
                            True)] * (red + 1)
    calls["K2"] += [k2_call(hq, hkv, shape["r_pad"], d, d, causal_pairs(shape["r_valid"]),
                            True)] * (t["num_hidden_layers"] - red - 1)
    n = shape["n_img"]
    fh = g["attn_fuse_num_heads"]
    dqk = (g["attn_fuse_size"] + g["visual_cond_size"]) // fh
    dv = g["attn_fuse_size"] // fh
    pairs = n * n if g["attn_fuse_global"] else n * win * win
    calls["K2"] += [k2_call(fh, fh, n, dqk, dv, pairs, True)] * len(g["selected_visual_layers"])
    return calls


def _linear(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def prefill_work(model: dict, shape: dict, int8_parts=()) -> Dict[str, float]:
    """{"bf16": flops, "int8": ops} of one pruned prefill over the valid
    tokens: the ViT (patch embed, blocks, merger), the decoder layers to
    the reduce layer over the whole row, the fuser, the layers after it
    over the kept row, and the head at the last position. ``int8_parts``
    names the products the tier runs in int8: "vision_blocks" and
    "text_prefill"; attention runs in bf16."""
    v, t, g = model["vision"], model["text"], model["gp"]
    work = {"bf16": 0.0, "int8": 0.0}

    def add(part: str, flops: float) -> None:
        work["int8" if part in int8_parts else "bf16"] += flops

    p, vh = shape["p"], v["hidden_size"]
    mu = v["spatial_merge_size"] ** 2
    in_dim = v["in_channels"] * v["temporal_patch_size"] * v["patch_size"] ** 2
    add("vision_embed", _linear(p, in_dim, vh))
    blk = (_linear(p, vh, 3 * vh) + _linear(p, vh, vh) + 2 * _linear(p, vh, v["intermediate_size"])
           + _linear(p, v["intermediate_size"], vh))
    add("vision_blocks", blk * v["depth"])
    for f, b in attention_calls(model, shape).items():
        add("attention", sum(c[0] for c in b))
    add("vision_merger", _linear(p // mu, mu * vh, mu * vh)
        + _linear(p // mu, mu * vh, v["out_hidden_size"]))
    h, i = t["hidden_size"], t["intermediate_size"]
    hq, hkv = t["num_attention_heads"], t["num_key_value_heads"]
    d = h // hq
    per_token = (_linear(1, h, hq * d) + 2 * _linear(1, h, hkv * d) + _linear(1, hq * d, h)
                 + 3 * _linear(1, h, i))
    red = min(g["reduce_layer"], t["num_hidden_layers"] - 1)
    add("text_prefill", per_token * (shape["s_valid"] * (red + 1)
                                     + shape["r_valid"] * (t["num_hidden_layers"] - red - 1)))
    n, fs, cond = shape["n_img"], g["attn_fuse_size"], g["visual_cond_size"]
    n_layers = len(g["selected_visual_layers"])
    fuser = (_linear(n, len(g["selected_layers"]) * hq, fs)
             + n_layers * (_linear(n, vh, cond) + 2 * _linear(n, fs + cond, fs + cond)
                           + 2 * _linear(n, fs, fs) + 3 * _linear(n, fs, 2 * fs))
             + _linear(n, fs, 1))
    add("fuser", fuser)
    add("head", _linear(1, h, t["vocab_size"]))
    return work


def decode_work(model: dict, context0: int, steps: int) -> float:
    """bf16 flops of ``steps`` decode steps of one request whose kept
    prefix holds context0 valid tokens: every layer's products, the head,
    and attention over the valid context (the prefix and the tokens fed so
    far, the fed one included), never the masked gap."""
    t = model["text"]
    h, i = t["hidden_size"], t["intermediate_size"]
    hq, hkv = t["num_attention_heads"], t["num_key_value_heads"]
    d, L = h // hq, t["num_hidden_layers"]
    per_step = L * (_linear(1, h, hq * d) + 2 * _linear(1, h, hkv * d) + _linear(1, hq * d, h)
                    + 3 * _linear(1, h, i)) + _linear(1, h, t["vocab_size"])
    ctx = sum(context0 + s + 1 for s in range(steps))
    return per_step * steps + 4.0 * ctx * d * hq * L

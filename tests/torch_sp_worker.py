"""One rank of the sequence-parallel CPU checks in test_torch_sp.py.

Started by ``glimpseprune_torch.parallel.launch`` over gloo; imports torch
and the port only (no jax). Every rank builds the same inputs from numpy
seeds and the same weights from the parent's ``.npz``, runs each check
unsharded and under ``sequence_parallel``, and returns numpy arrays for the
parent to hold against the JAX package and the unsharded port."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _model(cfg, weights_path):
    from glimpseprune_torch.convert import quantize_towers
    from glimpseprune_torch.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP

    with torch.device("meta"):
        model = quantize_towers(Qwen2_5_VL_GP(cfg), cfg)
    with np.load(weights_path) as npz:
        state = {k: torch.from_numpy(npz[k]) for k in npz.files}
    model.load_state_dict(state, strict=True, assign=True)
    return model.float().requires_grad_(False).eval()


def _collectives(rank, world, sp):
    """split_seq, gather_seq and gather_kv on [2, 4 * world, 3] tensors
    whose gradient weights w are the same on every rank (and, for
    gather_kv, differ by rank, as sharded compute's do)."""
    from glimpseprune_torch.parallel import gather_kv, gather_seq, split_seq

    rng = np.random.default_rng(5)
    x, w = (torch.as_tensor(rng.standard_normal((2, 4 * world, 3))) for _ in range(2))
    rows = sp.slice(x.shape[1])
    out = {}
    xs = x.clone().requires_grad_(True)
    y = split_seq(xs, 1, sp)
    (y * w[:, rows]).sum().backward()
    out["split"], out["split_grad"] = y.detach().numpy(), xs.grad.numpy()
    xl = x[:, rows].clone().requires_grad_(True)
    z = gather_seq(xl, 1, sp)
    (z * w).sum().backward()
    out["gather"], out["gather_grad"] = z.detach().numpy(), xl.grad.numpy()
    xl = x[:, rows].clone().requires_grad_(True)
    z = gather_kv(xl, 1, sp)
    (z * w * (rank + 1)).sum().backward()
    out["gather_kv"], out["gather_kv_grad"] = z.detach().numpy(), xl.grad.numpy()
    return out


def _attention(world, sp):
    """Each SP attention entry point on this rank's shard, gathered,
    beside the unsharded call -> {kind: (sp, whole, valid rows)}."""
    from glimpseprune_torch.ops.attention import (
        batched_window_attention,
        causal_segment_attention,
        fused_window_attention,
        segment_attention,
    )
    from glimpseprune_torch.parallel import gather_seq

    rng = np.random.default_rng(7)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    out = {}
    s = 64 * world
    rows = sp.slice(s)
    q, k, v = rand(s, 2, 16), rand(s, 2, 16), rand(s, 2, 16)
    seg = torch.zeros(s, dtype=torch.int32)
    seg[s // 2 + 5:] = 1  # two images and a padding tail, not on shard bounds
    seg[-13:] = -1
    for kind, dense in (("segment", False), ("segment_dense", True)):
        got = segment_attention(q[rows], k[rows], v[rows], seg[rows], dense=dense, sp=sp)
        want = segment_attention(q, k, v, seg, dense=dense)
        out[kind] = (gather_seq(got, 0, sp).numpy(), want.numpy(),
                     np.ones(s, bool) if dense else (seg >= 0).numpy())
    wp = 16
    p = wp * 2 * world
    rows = sp.slice(p)
    qkv, cos, sin = rand(p, 3, 2, 16), rand(p, 16), rand(p, 16)
    valid = torch.ones(p, dtype=torch.bool)
    valid[-9:] = False
    got = batched_window_attention(qkv[rows, 0], qkv[rows, 1], qkv[rows, 2], valid[rows], wp)
    want = batched_window_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2], valid, wp)
    out["window"] = (gather_seq(got, 0, sp).numpy(), want.numpy(), valid.numpy())
    got = fused_window_attention(qkv[rows], cos[rows], sin[rows], valid[rows], wp)
    want = fused_window_attention(qkv, cos, sin, valid, wp)
    out["fused_window"] = (gather_seq(got, 0, sp).numpy(), want.numpy(), valid.numpy())
    b, s = 2, 32 * world
    rows = sp.slice(s)
    q, k, v = rand(b, s, 4, 16), rand(b, s, 2, 16), rand(b, s, 2, 16)
    valid = torch.ones((b, s), dtype=torch.bool)
    valid[1, :29] = False  # left padding
    got = causal_segment_attention(q[:, rows], k[:, rows], v[:, rows], valid[:, rows],
                                   sp=sp)[0]
    want = causal_segment_attention(q, k, v, valid)[0]
    out["causal"] = (gather_seq(got, 1, sp).numpy(), want.numpy(), valid.numpy())
    return out


class _CountFlash:
    """Counts the calls into flash attention that run on a shard: K9's
    (q_positions given) and segment attention's with Sq != Skv."""

    def __init__(self, inner):
        self.inner, self.qpos, self.segment = inner, 0, 0

    def __call__(self, q, k, v, *args, q_positions=None, **kw):
        if q_positions is not None:
            self.qpos += 1
        elif q.shape[2] != k.shape[2]:
            self.segment += 1
        return self.inner(q, k, v, *args, q_positions=q_positions, **kw)


def _generate(cfg, model, prep):
    """The runner built outside the SP context and run inside it, pruned
    and unpruned, with the sharded flash calls of each run; then the
    compressors, which must refuse SP."""
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.ops import attention
    from glimpseprune_torch.parallel import sequence_parallel

    runner = GlimpsePruneRunner(cfg, model)
    counter = _CountFlash(attention.flash_attention)
    attention.flash_attention = counter
    out = {}
    try:
        with sequence_parallel(dist.group.WORLD):
            for sel in (True, False):
                counter.qpos = counter.segment = 0
                res = runner.generate(prep, max_new_tokens=4, do_selection=sel)
                out[sel] = {"sequences": res.sequences, "num_generated": res.num_generated,
                            "keep_img": res.keep_img, "mask_logits": res.mask_logits,
                            "k9_calls": counter.qpos, "segment_shard_calls": counter.segment}
            try:
                runner.generate_compressed(prep, "divprune", max_new_tokens=2,
                                           visual_token_num=2)
                out["compressed_refused"] = ""
            except ValueError as err:
                out["compressed_refused"] = str(err)
    finally:
        attention.flash_attention = counter.inner
    out["unsharded"] = runner.generate(prep, max_new_tokens=4).sequences
    return out


def _train_step(cfg, weights_path, prep):
    """One AdamW step (clip 1.0, weight decay 0.01, lr 1e-3) under SP on a
    fresh model -> loss, every trainable gradient, the updated weights."""
    from glimpseprune_torch.parallel import sequence_parallel
    from glimpseprune_torch.training.train_step import AdamW, init_trainable, make_train_step
    from glimpseprune_torch.training.trainer import batch_from_prep

    model = _model(cfg, weights_path)
    adamw = AdamW(init_trainable(model), 1e-3, weight_decay=0.01, max_grad_norm=1.0)
    step = make_train_step(cfg, model, adamw)
    with sequence_parallel(dist.group.WORLD):
        metrics = step(batch_from_prep(prep, "cpu"))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.numpy().copy() for k, p in adamw.params.items()},
            "params": {k: p.detach().numpy().copy() for k, p in adamw.params.items()}}


def run(rank: int, world: int, weights_path: str, serve_args, train_args):
    """Every check of one world size -> a dict of numpy results."""
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.parallel import get_sequence_parallel, sequence_parallel, sp_split

    torch.set_num_threads(1)
    cfg = tiny_test_config()
    out = {"sp_off": get_sequence_parallel() is None}
    with sequence_parallel(dist.group.WORLD):
        sp = get_sequence_parallel()
        out["collectives"] = _collectives(rank, world, sp)
        out["attention"] = _attention(world, sp)
        prep = prepare_inputs(cfg, *serve_args[:2], **serve_args[2])
        wp = (cfg.vision.window_size // cfg.vision.spatial_merge_size
              // cfg.vision.patch_size) ** 2 * cfg.vision.spatial_merge_unit
        out["sharded_sites"] = {"vit": sp_split(prep.patches.shape[0], wp) is not None,
                                "llm": sp_split(prep.input_ids.shape[1]) is not None,
                                "resume": sp_split(prep.out_len) is not None}
    out["sp_restored"] = get_sequence_parallel() is None
    out["generate"] = _generate(cfg, _model(cfg, weights_path), prep)
    out["train"] = _train_step(cfg, weights_path,
                               prepare_inputs(cfg, *train_args[:2], **train_args[2]))
    return out

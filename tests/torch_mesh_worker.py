"""One rank of the (data, model) mesh checks in test_torch_mesh.py and the
multi-process helper checks in test_torch_multihost.py.

Started by ``glimpseprune_torch.parallel.launch`` over gloo as 4 CPU ranks;
imports torch and the port only (no jax). Every rank builds the same inputs
from numpy seeds and the same weights from the parent's ``.npz``, runs each
check on a 2 x 2 mesh (tensor parallelism over the model axis, the batch or
the prefill's sequence over the data axis) and returns numpy arrays and
plain values for the parent to hold against the JAX package."""

from __future__ import annotations

import contextlib
import io
import json
import os

import numpy as np
import torch
import torch.distributed as dist

MODEL_AXIS = 2
MAX_NEW = 4
SERVE_NEW = 6


def _model(cfg, weights_path, tier="none"):
    from glimpseprune_torch.convert import quantize_towers
    from glimpseprune_torch.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
    from glimpseprune_torch.quantization import quantize_model, quantized_config

    with torch.device("meta"):
        model = quantize_towers(Qwen2_5_VL_GP(cfg), cfg)
    with np.load(weights_path) as npz:
        state = {k: torch.from_numpy(npz[k]) for k in npz.files}
    model.load_state_dict(state, strict=True, assign=True)
    model = model.float().requires_grad_(False).eval()
    if tier == "int8":
        quantize_model(model, "int8", cfg=quantized_config(cfg))
    return model


def _w8a8(mesh):
    """A row-parallel W8A8 product on this rank's contraction rows beside
    the unsharded product. Row 0's largest entry lies in the other rank's
    rows, so a local amax would give it another scale."""
    from glimpseprune_torch.quantization import matmul_w8a8, quantize_int8

    rng = np.random.default_rng(11)
    m, k, n = 5, 64, 24
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, k - 3] = 9.0
    w = quantize_int8(torch.as_tensor(rng.standard_normal((k, n)).astype(np.float32)))
    tp = mesh.model
    rows = slice(tp.rank * k // tp.world, (tp.rank + 1) * k // tp.world)
    xt = torch.as_tensor(x)
    got = matmul_w8a8(xt[:, rows], w["kernel_q"][rows], w["kernel_scale"], torch.float32, tp)
    local = matmul_w8a8(xt[:, rows], w["kernel_q"][rows], w["kernel_scale"], torch.float32)
    want = matmul_w8a8(xt, w["kernel_q"], w["kernel_scale"], torch.float32)
    return {"sharded": got.numpy(), "unsharded": want.numpy(), "local_amax": local.numpy()}


def _generate(cfg, weights_path, prep, mesh):
    """TP generate, pruned and unpruned, in both weight tiers; the local
    shapes that show the sharding."""
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.parallel import shard_params
    from glimpseprune_torch.quantization import quantized_config

    out = {}
    for tier in ("none", "int8"):
        model = shard_params(_model(cfg, weights_path, tier), mesh)
        runner = GlimpsePruneRunner(quantized_config(cfg) if tier == "int8" else cfg, model)
        for sel in (True, False):
            res = runner.generate(prep, max_new_tokens=MAX_NEW, do_selection=sel)
            out[(tier, sel)] = {"sequences": res.sequences, "num_generated": res.num_generated,
                                "keep_img": res.keep_img, "mask_logits": res.mask_logits}
        a = model.text.layers[0].self_attn
        out[(tier, "shapes")] = {
            "kv_heads": model.text.kv_heads, "decode_mode": runner.decode_mode,
            "embed_rows": model.text.embed_tokens.weight.shape[0],
            "o_proj_in": a.o_proj.in_features, "q_proj_out": a.q_proj.out_features}
        try:
            model.visual(torch.as_tensor(prep.patches), torch.as_tensor(prep.vis_pos_ids),
                         torch.as_tensor(prep.full_seg), torch.as_tensor(prep.vis_valid),
                         emit_importance=True)
            out[(tier, "importance_refused")] = ""
        except ValueError as err:
            out[(tier, "importance_refused")] = str(err)
    return out


def _serve(cfg, weights_path, prep, mesh):
    """The continuous batcher over TP weights, with SP over the data axis
    for the prefill: row 0's pruned prefill admitted twice."""
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.parallel import sequence_parallel, shard_params, sp_split
    from glimpseprune_torch.serving import ContinuousBatcher

    runner = GlimpsePruneRunner(cfg, shard_params(_model(cfg, weights_path), mesh))
    with sequence_parallel(mesh.data_group):
        sharded = sp_split(prep.input_ids.shape[1]) is not None

        def prefill():
            logits, valid, pos, kc, vc = runner.prefill(prep)[:5]
            return logits[:1], valid[:1], pos[:, :1], kc[:, :1], vc[:, :1]

        r = int(prefill()[1].shape[1])
        b = ContinuousBatcher(runner, capacity=2, prefix_len=r, max_new_tokens=SERVE_NEW,
                              inter_steps=2, eos=-1, max_requests=2)
        seqs, n_gen, _, _ = b.serve([prefill] * 2)
    return {"sequences": np.asarray(seqs), "num_generated": np.asarray(n_gen),
            "sp_sharded": sharded}


def _train(cfg, weights_path, prep, mesh, lr):
    """One AdamW step (clip 1.0, weight decay 0.01) on TP weights with the
    batch split over the data axis -> metrics, every trainable gradient,
    the updated weights."""
    from glimpseprune_torch.parallel import shard_params
    from glimpseprune_torch.training.train_step import AdamW, init_trainable, make_train_step
    from glimpseprune_torch.training.trainer import batch_from_prep

    model = shard_params(_model(cfg, weights_path), mesh)
    adamw = AdamW(init_trainable(model), lr, weight_decay=0.01, max_grad_norm=1.0)
    step = make_train_step(cfg, model, adamw, mesh=mesh)
    metrics = step(batch_from_prep(prep, "cpu"))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.numpy().copy() for k, p in adamw.params.items()},
            "params": {k: p.detach().numpy().copy() for k, p in adamw.params.items()}}


def _multihost(rank, world, workdir):
    """The JAX package's two-process contracts (tests/multihost_worker.py)
    across the ranks."""
    from glimpseprune_torch.evalsuite.data import shard_for_host
    from glimpseprune_torch.utils.failures import all_hosts_agree_ok, oom_resilient_step
    from glimpseprune_torch.utils.multihost import (
        gather_objects,
        host_id,
        merge_host_results,
        num_hosts,
    )

    out = {"hosts": (num_hosts(), host_id())}
    out["gathered"] = gather_objects({"host": rank, "payload": "x" * (10 + 100 * rank)})
    out["all_ok"] = all_hosts_agree_ok(True)
    out["one_failed"] = all_hosts_agree_ok(rank != 1)

    @oom_resilient_step(skip_value="skipped")
    def step():
        if rank == 1:
            raise RuntimeError("RESOURCE_EXHAUSTED: a planted OOM")
        return "ran"

    out["oom_step"] = step()
    try:
        gather_objects("y" * (200 if rank == 2 else 1), max_bytes=64)
        out["too_large"] = ""
    except ValueError as err:
        out["too_large"] = str(err)
    samples = [{"question_id": f"q{i}", "answer": i} for i in range(7)]
    mine = shard_for_host(samples, host_id(), num_hosts())
    out["shard_ids"] = [s["question_id"] for s in mine]
    path = os.path.join(workdir, f"shard_{rank}.jsonl")
    with open(path, "w") as f:
        f.write("".join(json.dumps(s) + "\n" for s in mine))
        if rank == 1:  # a record another rank also wrote: merged once
            f.write(json.dumps(samples[0]) + "\n")
    paths = gather_objects(path)  # a barrier too: every shard is on disk
    out["paths"] = paths
    if rank == 0:
        merged = os.path.join(workdir, "merged.jsonl")
        out["merged_n"] = merge_host_results(paths, merged)
        with open(merged) as f:
            out["merged_ids"] = [json.loads(line)["question_id"] for line in f]
    return out


def _train_cli(cli_args):
    """``train_gp --mesh`` on every rank: the default mesh of 4 ranks
    (model axis 4) over the tiny config, one step."""
    from glimpseprune_torch.tools import train_gp

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ckpt = train_gp.main(cli_args + ["--mesh", "--max-steps", "1"])
    dist.barrier()
    with open(os.path.join(ckpt, "train_log.json")) as f:
        history = json.load(f)
    return {"stdout": buf.getvalue(), "steps": [h["step"] for h in history],
            "loss": [h["loss"] for h in history]}


def run(rank: int, world: int, weights_path: str, serve_args, train_args, workdir: str,
        cli_args, lr: float):
    """Every check of the 4-rank launch -> a dict of numpy results."""
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.parallel import make_mesh

    torch.set_num_threads(1)
    cfg = tiny_test_config()
    mesh = make_mesh(model_axis=MODEL_AXIS)
    out = {"mesh": (mesh.shape, mesh.data_index, mesh.model_index)}
    prep = prepare_inputs(cfg, *serve_args[:2], **serve_args[2])
    out["w8a8"] = _w8a8(mesh)
    out["generate"] = _generate(cfg, weights_path, prep, mesh)
    out["serve"] = _serve(cfg, weights_path, prep, mesh)
    out["train"] = _train(cfg, weights_path, prepare_inputs(cfg, *train_args[:2],
                                                            **train_args[2]), mesh, lr)
    out["multihost"] = _multihost(rank, world, workdir)
    out["train_cli"] = _train_cli(cli_args)
    return out

"""One rank of the (data, model) mesh checks in test_torch_mesh.py and the
multi-process helper checks in test_torch_multihost.py.

Started by ``glimpseprune_torch.parallel.launch`` over gloo as 4 CPU ranks;
imports torch and the port only (no jax). Every rank builds the same inputs
from numpy seeds and the same weights from the parent's ``.npz``, runs each
check on a 2 x 2 mesh (tensor parallelism over the model axis, the batch or
the prefill's sequence over the data axis) and returns numpy arrays and
plain values for the parent to hold against the JAX package. The (q4)
tier runs on a wider tiny config (``q4_mesh_config``), whose row-parallel
int4 decoder layers can be cut in two (a local contraction that is a
multiple of 2 g, g = 64); the tiny config's cannot, and stay whole."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import torch
import torch.distributed as dist

MODEL_AXIS = 2
MAX_NEW = 4
SERVE_NEW = 6
COMPRESSORS = ("visionzip", "divprune", "cdpruner", "vscan", "pdrop")
PDROP_STAGES = ((1, 0.5), (2, 0.25))


def q4_mesh_config(cfg):
    """The tiny config (either package's) with a decoder of hidden and
    intermediate size 256 in 16 heads of 16: o_proj's and down_proj's
    contraction of 256 splits in two halves of 128 = 2 g."""
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, hidden_size=256, intermediate_size=256,
                                      num_attention_heads=16),
        vision=dataclasses.replace(cfg.vision, out_hidden_size=256))


def q4_config(cfg):
    from glimpseprune_torch.quantization import quantized_config

    return quantized_config(cfg, "int4", act_quant="prefill")


def compressor_kwargs(method):
    """tests/test_torch_compressors.py's arguments: the rows have 6 and 4
    image tokens."""
    kwargs = dict(max_new_tokens=MAX_NEW)
    if method in ("divprune", "cdpruner", "vscan"):
        kwargs["visual_token_num"] = 2
    if method == "pdrop":
        kwargs["stages"] = PDROP_STAGES
    return kwargs


def compressed_record(res):
    return {"sequences": res.sequences, "num_generated": res.num_generated,
            "keep_img": res.keep_img, "prune_ratio": res.prune_ratio}


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
    elif tier == "int4":
        quantize_model(model, "int4", cfg=q4_config(cfg))
    return model


def _w4a8_rows(mesh):
    """The row-parallel W4A8 product (K6's arithmetic) on this rank's
    contraction rows beside the unsharded plain version, at a tiny shape
    (called directly) and at a K6-routed one (through ``matmul_int4_auto``).
    Row 0's largest entry and the largest group scale of column 0 lie in
    the other rank's rows, so scales taken locally round otherwise."""
    from glimpseprune_torch.ops.cuda.int4_matmul import (
        int4_a8_prep_reference,
        int8_gemm_tn_reference,
    )
    from glimpseprune_torch.parallel.mesh import _int4_rows
    from glimpseprune_torch.parallel.sequence import reduce_from_model
    from glimpseprune_torch.quantization import _int4_a8_row, matmul_int4_auto, quantize_int4

    tp = mesh.model
    out = {}
    for name, (m, k, n) in {"tiny": (5, 256, 64), "k6": (160, 1024, 512)}.items():
        rng = np.random.default_rng(13)
        x = rng.standard_normal((m, k)).astype(np.float32)
        x[0, k - 3] = 9.0
        w = rng.standard_normal((k, n)).astype(np.float32)
        w[k - 5, 0] = 8.0
        x, q = torch.as_tensor(x).bfloat16(), quantize_int4(torch.as_tensor(w))
        packed, scales = _int4_rows(q["kernel_q4"], q["kernel_scale4"], tp)
        xl = x[:, tp.slice(k)].contiguous()
        if name == "tiny":
            got = _int4_a8_row(xl, packed, scales, torch.bfloat16, tp)
        else:
            got = matmul_int4_auto(xl, packed, scales, torch.bfloat16, True, tp, "row")
        want = int8_gemm_tn_reference(*int4_a8_prep_reference(x, q["kernel_q4"],
                                                              q["kernel_scale4"]),
                                      torch.bfloat16)
        local = reduce_from_model(int8_gemm_tn_reference(
            *int4_a8_prep_reference(xl, packed, scales), torch.float32), tp).bfloat16()
        out[name] = {"sharded": got.float().numpy(), "unsharded": want.float().numpy(),
                     "local_scales": local.float().numpy()}
        if name == "k6":
            out[name]["auto"] = matmul_int4_auto(x, q["kernel_q4"], q["kernel_scale4"],
                                                 torch.bfloat16, True).float().numpy()
    return out


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


def _generate(cfg, weights_path, prep, mesh, q4_args):
    """TP generate, pruned and unpruned, in the three weight tiers ((q4) on
    ``q4_mesh_config``'s weights); the local shapes that show the sharding;
    the ViT's importance scores on the mesh beside the unsharded model's."""
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.parallel import shard_params
    from glimpseprune_torch.quantization import quantized_config

    out = {}
    for tier in ("none", "int8", "int4"):
        if tier == "int4":
            cfg, weights_path, prep = q4_args
        vis_args = [torch.as_tensor(a) for a in (prep.patches, prep.vis_pos_ids,
                                                 prep.full_seg, prep.vis_valid)]
        whole = _model(cfg, weights_path, tier)
        with torch.inference_mode():
            imp_whole = whole.visual(*vis_args, emit_importance=True)[2]
        model = shard_params(whole, mesh)
        tcfg = {"none": cfg, "int8": quantized_config(cfg), "int4": q4_config(cfg)}[tier]
        runner = GlimpsePruneRunner(tcfg, model)
        for sel in (True, False):
            res = runner.generate(prep, max_new_tokens=MAX_NEW, do_selection=sel)
            out[(tier, sel)] = {"sequences": res.sequences, "num_generated": res.num_generated,
                                "keep_img": res.keep_img, "mask_logits": res.mask_logits}
        a, mlp = model.text.layers[0].self_attn, model.text.layers[0].mlp
        out[(tier, "shapes")] = {
            "kv_heads": model.text.kv_heads, "decode_mode": runner.decode_mode,
            "embed_rows": model.text.embed_tokens.weight.shape[0],
            "o_proj_in": a.o_proj.in_features, "q_proj_out": a.q_proj.out_features}
        if tier == "int4":  # the row-parallel int4 layers' local buffers
            out[(tier, "int4_rows")] = {
                name: (lin.mode, lin.tp_mode, tuple(lin.kernel_q4.shape),
                       tuple(lin.kernel_scale4.shape))
                for name, lin in (("o_proj", a.o_proj), ("down_proj", mlp.down_proj),
                                  ("vit_proj", model.visual.blocks[0].attn.proj))}
        with torch.inference_mode():
            imp = model.visual(*vis_args, emit_importance=True)[2]
        out[(tier, "importance")] = {"sharded": [t.numpy() for t in imp],
                                     "unsharded": [t.numpy() for t in imp_whole]}
    return out


def _compressed(cfg, weights_path, prep, mesh):
    """The five compressors' ``generate_compressed`` on TP weights."""
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.parallel import shard_params

    runner = GlimpsePruneRunner(cfg, shard_params(_model(cfg, weights_path), mesh))
    return {m: compressed_record(runner.generate_compressed(prep, m, **compressor_kwargs(m)))
            for m in COMPRESSORS}


def _grpo(cfg, weights_path, mesh, grpo_args):
    """One GRPO step over LoRA adapters on TP weights (every rank on the
    same fixed batch) -> metrics, reference logprobs, every adapter's whole
    gradient, the whole adapters after the step; ``save_lora`` of the mesh's
    adapters before and after the step (on every rank, each to its own
    directory); the policy's logprobs with the adapters put in before
    ``shard_params`` (the other order) beside those put in after."""
    import dataclasses

    from glimpseprune_torch.parallel import shard_params
    from glimpseprune_torch.persistence import save_lora
    from glimpseprune_torch.training import grpo
    from glimpseprune_torch.training.lora import insert_lora, lora_parameters, lora_tree
    from glimpseprune_torch.training.train_step import AdamW

    lora_np, batch_np, rank_, lr, workdir = grpo_args
    lora = {p: {k: torch.as_tensor(v) for k, v in ab.items()} for p, ab in lora_np.items()}
    r = next(iter(lora.values()))["a"].shape[-1]
    pcfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, lora_rank=r, remat=True))
    batch = grpo.GRPOBatch(**{k: torch.as_tensor(v) for k, v in batch_np.items()})

    after = shard_params(_model(cfg, weights_path), mesh)
    insert_lora(after, lora, cfg=pcfg)
    before = _model(cfg, weights_path)
    insert_lora(before, lora, cfg=pcfg)
    shard_params(before, mesh)
    with torch.no_grad():
        orders = [grpo.completion_logps(m, batch).numpy() for m in (after, before)]
    save_lora(lora_tree(after), os.path.join(workdir, f"lora_{rank_}_before"))
    ref = grpo.compute_ref_logps(after, batch)
    batch = batch._replace(ref_logps=ref)
    params = lora_parameters(after)
    metrics = grpo.make_grpo_loss_step(after, AdamW(params, lr), 1.0, 0.04)(batch)
    from glimpseprune_torch.training.lora import _whole

    grads = {}
    for name, p in params.items():
        mod = after.get_submodule(name.rsplit(".", 1)[0])
        grads[name] = _whole(mod, name[-1], p.grad).numpy()
    tree = lora_tree(after)
    save_lora(tree, os.path.join(workdir, f"lora_{rank_}_after"))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "ref_logps": ref.numpy(),
            "grads": grads, "lora": {p: {k: v.numpy() for k, v in ab.items()}
                                     for p, ab in tree.items()},
            "orders": orders,
            "b_local": tuple(after.text.layers[0].self_attn.q_proj.lora_b.shape),
            "a_local": tuple(after.text.layers[0].self_attn.o_proj.lora_a.shape)}


def _llava(mesh, llava_args):
    """LLaVA TP generate, pruned and unpruned; the local shapes."""
    from glimpseprune_torch.convert import new_model, quantize_towers
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.parallel import shard_params

    cfg, cc, weights_path, prep = llava_args
    with torch.device("meta"):
        model = quantize_towers(new_model(cfg, cc), cfg)
    with np.load(weights_path) as npz:
        state = {k: torch.from_numpy(npz[k]) for k in npz.files}
    model.load_state_dict(state, strict=True, assign=True)
    model = shard_params(model.float().requires_grad_(False).eval(), mesh)
    runner = GlimpsePruneRunner(cfg, model)
    out = {}
    for sel in (True, False):
        res = runner.generate(prep, max_new_tokens=MAX_NEW, do_selection=sel)
        out[sel] = {"sequences": res.sequences, "num_generated": res.num_generated,
                    "keep_img": res.keep_img, "mask_logits": res.mask_logits}
    a = model.text.layers[0].self_attn
    out["shapes"] = {"q_proj": tuple(a.q_proj.weight.shape), "kv_heads": model.text.kv_heads,
                     "clip_q": tuple(model.visual.layers[0].self_attn.q_proj.weight.shape),
                     "projector": tuple(model.mm_projector_fc2.weight.shape),
                     "clip_sharded": any(getattr(m, "tp", None) is not None
                                         for m in model.visual.modules())}
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
        cli_args, lr: float, q4_weights: str, grpo_args, llava_args):
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
    out["w4a8"] = _w4a8_rows(mesh)
    cfg4 = q4_mesh_config(cfg)
    q4_args = (cfg4, q4_weights, prepare_inputs(cfg4, *serve_args[:2], **serve_args[2]))
    out["generate"] = _generate(cfg, weights_path, prep, mesh, q4_args)
    out["compressed"] = _compressed(cfg, weights_path, prep, mesh)
    out["grpo"] = _grpo(cfg, weights_path, mesh, grpo_args + (rank, lr, workdir))
    out["llava"] = _llava(mesh, llava_args)
    out["serve"] = _serve(cfg, weights_path, prep, mesh)
    out["train"] = _train(cfg, weights_path, prepare_inputs(cfg, *train_args[:2],
                                                            **train_args[2]), mesh, lr)
    out["multihost"] = _multihost(rank, world, workdir)
    out["train_cli"] = _train_cli(cli_args)
    return out

"""The port's (data, model) mesh (glimpseprune_torch/parallel/mesh.py)
against the JAX package's (glimpseprune_tpu/parallel/mesh.py).

In one process: the mesh shapes against JAX ``make_mesh`` on the suite's 8
virtual devices, the rule table, every leaf of the tiny config's JAX tree
(unquantized, int8 and int4, whose row-parallel shards are repacked)
reassembled from the port's shards over a model axis of 2, the batch
split against JAX ``shard_batch``'s shards, which (q4) units stay whole
and LLaVA's towers, and adapters and sharding in either order.

Over one launch of 4 gloo CPU ranks as a 2 x 2 mesh (tests/torch_mesh_worker.py,
which imports no jax; weights arrive as an ``.npz``): the row-parallel W8A8
and W4A8 products bit-equal to the unsharded ones, tensor-parallel (TP)
``generate`` pruned and unpruned in the three weight tiers against the
JAX runner on one device, the ViT's importance scores on the mesh, the
five compressors, a LoRA GRPO step against JAX's and ``save_lora`` from
the mesh against one process's, LLaVA's ``generate``, the continuous
batcher over TP weights with sequence parallelism over the data axis
against JAX ``generate``, one TP x data-parallel train step against JAX
``make_train_step`` on the whole batch, the multi-process helpers across
the ranks (JAX tests/multihost_worker.py) and ``train_gp --mesh``."""

import copy
import dataclasses
import functools
import json
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_llava
import torch_mesh_worker
from glimpseprune_tpu.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP as JaxModel
from glimpseprune_tpu.models.qwen2_5_vl.runner import GlimpsePruneRunner as JaxRunner
from glimpseprune_tpu.models.qwen2_5_vl.runner import prepare_inputs as jax_prepare_inputs
from glimpseprune_tpu.parallel import mesh as jax_mesh
from glimpseprune_tpu.quantization import quantize_int4 as jax_quantize_int4
from glimpseprune_tpu.quantization import quantize_int8 as jax_quantize_int8
from glimpseprune_tpu.quantization import quantized_config as jax_quantized_config
from glimpseprune_tpu.training import grpo as jax_grpo
from glimpseprune_tpu.training import lora as jax_lora
from test_torch_cli import model_args, write_inputs
from test_torch_delayed import assert_close
from test_torch_grpo import fixed_batch
from test_torch_inputs import random_params
from test_torch_sp import LR, _args, jax_train_step
from test_torch_training import LOSS_TOL, METRIC_KEYS, torch_names, train_setup

LORA_RANK = 2

WORLD = 4

MESH_CASES = [(1, None), (2, None), (4, None), (8, None), (4, 1), (4, 2), (8, 1), (8, 2),
              (8, 4)]


# ------------------------------------------------------------------ one process


@pytest.mark.parametrize("n,model_axis", MESH_CASES)
def test_mesh_shape_matches_jax(n, model_axis):
    from glimpseprune_torch.parallel import mesh_shape

    want = jax_mesh.make_mesh(n, model_axis=model_axis).shape
    assert mesh_shape(n, model_axis) == dict(want)


def test_mesh_shape_refuses_an_axis_that_does_not_divide():
    from glimpseprune_torch.parallel import make_mesh, mesh_shape

    with pytest.raises(ValueError):
        mesh_shape(6, 4)
    mesh = make_mesh()  # no process group: one rank
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_group is None
    with pytest.raises(ValueError):
        make_mesh(2)


def _jax_path(port_key: str, ndim: int) -> str:
    """A port state-dict key -> the JAX parameter path its leaf comes from
    (stacked layers unindexed)."""
    name = re.sub(r"^(text\.layers|visual\.blocks)\.\d+\.", r"\1.", port_key)
    if "." not in name:  # a top-level array (the glimpse embeddings)
        return name
    base, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        leaf = ("embedding" if base.endswith("embed_tokens")
                else "kernel" if ndim == 2 else "scale")
    return re.sub(r"\.(\d+)(?=\.|$)", r"_\1", base).replace(".", "/") + "/" + leaf


@functools.lru_cache(maxsize=None)
def q4_setup():
    """(config, JAX params) of the (q4) mesh checks: ``q4_mesh_config``'s
    wider decoder, random weights drawn as train_setup's."""
    cfg = torch_mesh_worker.q4_mesh_config(train_setup()[0])
    prep = jax_prepare_inputs(cfg, *_args(False)[:2], **_args(False)[2])
    return cfg, random_params(JaxModel(cfg), prep, 0)


def jax_tier(tier):
    """(cfg, JAX params) of the mesh checks' weights in a tier."""
    cfg, _, _, _, params = train_setup()
    if tier == "int8":
        return jax_quantized_config(cfg), jax_quantize_int8(params)
    if tier == "int4":
        cfg, params = q4_setup()
        return jax_quantized_config(cfg, "int4", act_quant="prefill"), jax_quantize_int4(params)
    return cfg, params


def _jax_dim(path: str):
    spec = jax_mesh.param_sharding_rules(path)
    return list(spec).index("model") if "model" in tuple(spec) else None


def test_rule_table_matches_jax():
    """The port's table gives the dim of JAX's spec for every leaf path of
    the tiny config's tree, quantized leaves included."""
    from glimpseprune_torch.parallel import param_sharding_rules

    _, _, _, _, params = train_setup()
    paths = ["/".join(str(k.key) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jax_quantize_int8(params))[0]]
    paths += ["/".join(str(k.key) for k in p)
              for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert any(_jax_dim(p) is not None for p in paths)
    for p in paths:
        assert param_sharding_rules(p) == _jax_dim(p), p


def _port_dim(key: str, full: torch.Tensor, cfg, whole=()):
    """Where the port shards the leaf ``key`` over 2 ranks: JAX's dim after
    its divisibility drop, in the port's layout (a Dense kernel is the
    transposed weight; stacked layers are split); for an int8 scale [1, out]
    of a column-parallel kernel, its columns; the ViT's merger, which JAX
    shards, whole (parallel/mesh.py says why); -> (dim, per-head split)."""
    path = _jax_path(key, full.ndim)
    if path.startswith(("visual/merger_",) + tuple(whole)):
        return None, False
    stacked = key.startswith(("text.layers.", "visual.blocks."))
    if path.endswith("/kernel_scale4"):  # with its kernel: columns, or a row layer's rows
        d = _jax_dim(path[: -len("_scale4")] + "_q4")
        if d is None:
            return None, False
        return (full.ndim - 2 if d - stacked == 0 else full.ndim - 1,
                "visual/blocks/attn/qkv" in path)
    if path.endswith("/kernel_scale"):
        d = _jax_dim(path[: -len("_scale")] + "_q")
        return (None if d is None or d - stacked != full.ndim - 1
                else full.ndim - 1), "visual/blocks/attn/qkv" in path
    d = _jax_dim(path)
    if d is None:
        return None, False
    d -= stacked
    if path.endswith("/kernel") and full.ndim == 2:
        d = 1 - d
    if full.shape[d] % 2:
        return None, False
    return d, path.startswith("visual/blocks/attn/qkv/")


@pytest.mark.parametrize("tier", ["none", "int8", "int4"])
def test_shards_reassemble_to_the_jax_leaves(tier):
    """Every leaf of the JAX tree: the two ranks' shards, put back together
    along the sharded dim (for the ViT qkv per (3, heads, D); a row-parallel
    int4 kernel's shards unpacked, stacked and packed again), equal the
    unsharded port leaf, which is the JAX leaf (``params_from_jax``); a
    replicated leaf is whole on both ranks."""
    from glimpseprune_torch.convert import load_from_jax, params_from_jax
    from glimpseprune_torch.ops.cuda.int4_matmul import unpack_int4
    from glimpseprune_torch.parallel import Mesh, shard_params

    cfg, params = jax_tier(tier)
    full = params_from_jax(params, cfg)
    shards = []
    for rank in range(2):
        model = load_from_jax(params, cfg, device="cpu")
        shard_params(model, Mesh({"data": 1, "model": 2}, 0, rank))
        shards.append(model.state_dict())
    heads = cfg.vision.num_heads
    # (q4): the ViT's int4 units stay whole
    whole_units = ("visual/blocks/",) if tier == "int4" else ()
    n_sharded = 0
    for key, want in full.items():
        dim, per_head = _port_dim(key, want, cfg, whole_units)
        got = [s[key] for s in shards]
        if dim is None:
            for g in got:
                torch.testing.assert_close(g, want, rtol=0, atol=0, msg=key)
            continue
        n_sharded += 1
        assert all(g.shape[dim] == want.shape[dim] // 2 for g in got), key
        if key.endswith("kernel_q4") and dim == want.ndim - 2:  # repacked rows
            q = torch.cat([unpack_int4(g) for g in got], dim)
            half = q.shape[dim] // 2
            whole = (q.narrow(dim, 0, half) & 0x0F) | (q.narrow(dim, half, half) << 4)
        elif per_head:
            split = lambda t: t.reshape(t.shape[:dim] + (3, -1, t.shape[dim] // 3 // (
                heads // 2)) + t.shape[dim + 1:])
            whole = torch.cat([split(g) for g in got], dim + 1).reshape(want.shape)
        else:
            whole = torch.cat(got, dim)
        torch.testing.assert_close(whole, want, rtol=0, atol=0, msg=key)
    n_layers = cfg.text.num_hidden_layers
    # q/k/v/o + gate/up/down per decoder layer (and the biases of q/k/v),
    # embedding and head, every ViT block's 5 kernels; (q4): each decoder
    # kernel with its scales, the ViT whole
    if tier == "int4":
        assert n_sharded >= 2 * 7 * n_layers + 3
    else:
        assert n_sharded >= 7 * n_layers + 2 + 5 * cfg.vision.depth


def test_shard_batch_matches_jax_shards():
    """This data rank's rows of each array equal the shard of JAX's
    ``shard_batch`` on the devices of that data index (a 2 x 4 mesh); the
    packed vision arrays are whole."""
    from glimpseprune_torch.parallel import Mesh, shard_batch
    from glimpseprune_torch.training.trainer import batch_from_prep

    _, _, prep_t, _, _ = train_setup()
    batch = batch_from_prep(prep_t, "cpu")
    jmesh = jax_mesh.make_mesh(8, model_axis=4)
    jbatch = jax_mesh.shard_batch({k: v.numpy() for k, v in batch.items()}, jmesh)
    for d in range(2):
        got = shard_batch(batch, Mesh({"data": 2, "model": 4}, d, 0))
        dev = jmesh.devices[d, 0]
        for k, v in got.items():
            (shard,) = [s for s in jbatch[k].addressable_shards if s.device == dev]
            np.testing.assert_array_equal(v.numpy(), np.asarray(shard.data), err_msg=k)
        for k in ("patches", "vis_pos_ids", "full_seg", "vis_valid"):
            assert got[k] is batch[k]
        assert got["input_ids"].shape[0] == 1 and got["position_ids"].shape[1] == 1


def test_shard_params_refuses_q4_and_llava():
    """(q4) and LLaVA now shard. On the tiny config the (q4) tier's groups
    (g = 32 for the K = 64 o_proj, 64 for the K = 128 down_proj) leave
    every row-parallel int4 layer a local contraction of no multiple of
    2 g, so its whole unit stays replicated (unit-or-nothing), the vocab
    alone sharded; ``q4_mesh_config``'s decoder (K = 256) shards, and the
    ViT's int4 units stay whole (parallel/mesh.py says why), also where
    their rows could be cut (a ViT of width 256). LLaVA shards its decoder
    (q / kv heads, the MLP, the vocab) and leaves the CLIP towers and the
    projector whole on every rank, as JAX's rules do."""
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.models.llava import gp_model as tgp
    from glimpseprune_torch.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
    from glimpseprune_torch.parallel import Mesh, shard_params
    from glimpseprune_torch.quantization import quantize_model
    from test_torch_llava import tiny_configs

    mesh = Mesh({"data": 1, "model": 2}, 0, 0)
    cfg = tiny_test_config()
    model = shard_params(quantize_model(Qwen2_5_VL_GP(cfg), "int4"), mesh)
    layer = model.text.layers[0]
    assert layer.self_attn.o_proj.tp is None and layer.self_attn.q_proj.tp is None
    assert layer.mlp.down_proj.tp is None and model.text.attn_tp is None
    assert model.text.lm_head.tp is not None and model.text.vocab_tp is not None
    model = shard_params(quantize_model(
        Qwen2_5_VL_GP(torch_mesh_worker.q4_mesh_config(cfg)), "int4"), mesh)
    for blk, sharded in ((model.text.layers[0].self_attn, True), (model.text.layers[0].mlp, True),
                         (model.visual.blocks[0].attn, False), (model.visual.blocks[0].mlp, False)):
        lins = [lin for lin in blk.children() if hasattr(lin, "tp")]
        assert lins and all((lin.tp is not None) == sharded for lin in lins)
    o = model.text.layers[0].self_attn.o_proj
    assert o.mode == "int4" and o.tp_mode == "row" and o.in_features == 128
    assert o.kernel_scale4.shape == (2, 256)
    wide_vit = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, hidden_size=256, intermediate_size=512))
    with torch.device("meta"):
        model = shard_params(quantize_model(Qwen2_5_VL_GP(wide_vit), "int4"), mesh)
    blk = model.visual.blocks[0]
    assert blk.attn.proj.mode == "int4" and blk.attn.proj.in_features == 256
    assert blk.attn.proj.tp is None and blk.mlp.down_proj.tp is None
    assert model.visual.attn_tp is None
    lcfg, cc = tiny_configs(tgp)
    llava = shard_params(tgp.Llava_GP(lcfg, cc), mesh)
    a = llava.text.layers[0].self_attn
    assert a.q_proj.tp_mode == "column" and a.o_proj.tp_mode == "row"
    assert a.q_proj.out_features == lcfg.text.hidden_size // 2
    assert llava.text.vocab_tp is not None and llava.text.attn_tp is not None
    assert not any(getattr(m, "tp", None) is not None
                   for tower in (llava.visual, llava.clip_text) for m in tower.modules())
    assert llava.mm_projector_fc2.tp is None
    with pytest.raises(ValueError, match="already sharded"):
        shard_params(llava, mesh)


def test_lora_and_sharding_refuse_each_other():
    """Adapters and sharding now accept each other in either order:
    ``insert_lora`` on a sharded model and ``shard_params`` on an adapted
    one leave each rank the same adapter parts (a column layer the whole
    ``lora_a`` and its columns of ``lora_b``, the ViT's qkv's per head; a
    row layer its rows of ``lora_a`` and the whole ``lora_b``), and
    ``apply_lora`` merges a shard's own part into its weight slice."""
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.models.layers import attach_lora
    from glimpseprune_torch.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
    from glimpseprune_torch.parallel import Mesh, shard_params
    from glimpseprune_torch.training.lora import apply_lora, insert_lora

    cfg = tiny_test_config()
    torch.manual_seed(0)
    base = Qwen2_5_VL_GP(cfg)
    targets = ("text/layers/self_attn/q_proj/kernel", "text/layers/self_attn/o_proj/kernel")
    rng = np.random.default_rng(3)
    tree = {}
    for path in targets:
        mod = base.get_submodule(path.removesuffix("/kernel").replace("/", ".")
                                 .replace("layers.", "layers.0."))
        lead = (cfg.text.num_hidden_layers,)
        tree[path] = {"a": rng.standard_normal(lead + (mod.in_features, LORA_RANK)),
                      "b": rng.standard_normal(lead + (LORA_RANK, mod.out_features))}
        tree[path] = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in tree[path].items()}
    vis = copy.deepcopy(base)
    qkv = vis.visual.blocks[0].attn.qkv
    attach_lora([qkv], LORA_RANK)
    with torch.no_grad():
        qkv.lora_b.copy_(torch.as_tensor(rng.standard_normal(qkv.lora_b.shape)))
    vis_b = qkv.lora_b.detach().clone()
    for rank in range(2):
        mesh = Mesh({"data": 1, "model": 2}, 0, rank)
        first = shard_params(copy.deepcopy(base), mesh)
        insert_lora(first, tree)
        second = insert_lora(copy.deepcopy(base), tree)
        shard_params(second, mesh)
        for name, m in first.named_modules():
            if getattr(m, "lora_a", None) is not None:
                other = second.get_submodule(name)
                assert torch.equal(m.lora_a, other.lora_a) and torch.equal(m.lora_b, other.lora_b)
        q, o = first.text.layers[1].self_attn.q_proj, first.text.layers[1].self_attn.o_proj
        cols, rows = slice(rank * 32, rank * 32 + 32), slice(rank * 32, rank * 32 + 32)
        assert torch.equal(q.lora_a, tree["text/layers/self_attn/q_proj/kernel"]["a"][1])
        assert torch.equal(q.lora_b, tree["text/layers/self_attn/q_proj/kernel"]["b"][1][:, cols])
        assert torch.equal(o.lora_a, tree["text/layers/self_attn/o_proj/kernel"]["a"][1][rows])
        assert torch.equal(o.lora_b, tree["text/layers/self_attn/o_proj/kernel"]["b"][1])
        merged = apply_lora(shard_params(copy.deepcopy(base), mesh), tree)
        whole = apply_lora(base, tree)
        assert torch.equal(merged.text.layers[1].self_attn.o_proj.weight,
                           whole.text.layers[1].self_attn.o_proj.weight[:, rows])
        assert torch.equal(merged.text.layers[1].self_attn.q_proj.weight,
                           whole.text.layers[1].self_attn.q_proj.weight[cols])
        per_head = vis_b.reshape(LORA_RANK, 3, 4, -1)[:, :, rank * 2:rank * 2 + 2].reshape(
            LORA_RANK, -1)  # the ViT's qkv: 4 heads, [3, heads, D] columns
        assert torch.equal(shard_params(copy.deepcopy(vis), mesh).visual.blocks[0].attn.qkv.lora_b,
                           per_head)


def test_saves_from_a_sharded_model(tmp_path):
    """``save_full_params`` refuses a model sharded over two ranks (its
    state dict is one rank's slices); ``save_new_modules`` writes the
    GlimpsePrune modules, which are never sharded, as one process does."""
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
    from glimpseprune_torch.parallel import Mesh, shard_params
    from glimpseprune_torch.persistence import (
        NEW_MODULES_FILE,
        save_full_params,
        save_new_modules,
    )

    cfg = tiny_test_config()
    torch.manual_seed(0)
    base = Qwen2_5_VL_GP(cfg)
    sharded = shard_params(copy.deepcopy(base), Mesh({"data": 1, "model": 2}, 0, 1))
    with pytest.raises(ValueError, match="sharded over a model axis of 2"):
        save_full_params(sharded, cfg, str(tmp_path / "full"))
    assert not (tmp_path / "full").exists()
    save_new_modules(sharded, cfg, str(tmp_path / "mesh"))
    save_new_modules(base, cfg, str(tmp_path / "one"))
    got = torch.load(tmp_path / "mesh" / NEW_MODULES_FILE, weights_only=True)
    want = torch.load(tmp_path / "one" / NEW_MODULES_FILE, weights_only=True)
    flat = lambda d, p="": ({p + k: v for k, v in d.items() if torch.is_tensor(v)}
                            | {kk: vv for k, v in d.items() if isinstance(v, dict)
                               for kk, vv in flat(v, p + k + ".").items()})
    assert flat(got).keys() == flat(want).keys()
    for k, v in flat(want).items():
        assert torch.equal(flat(got)[k], v), k


# ------------------------------------------------------------------ 4 ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the one 4-rank launch."""
    from glimpseprune_torch.convert import params_from_jax
    from glimpseprune_torch.parallel import launch

    cfg, _, _, _, params = train_setup()
    root = tmp_path_factory.mktemp("mesh")
    weights = root / "weights.npz"
    np.savez(weights, **{k: v.numpy() for k, v in params_from_jax(params, cfg).items()})
    cli = write_inputs(str(root / "cli"))
    cli_args = (["--config", cli.train, "--data-config", cli.data, "--img-dir", cli.img_dir,
                 "--output-dir", str(root / "cli" / "ckpt")] + model_args(cli))
    work = root / "multihost"
    work.mkdir()
    q4_weights = root / "weights_q4.npz"
    cfg4, params4 = q4_setup()
    np.savez(q4_weights, **{k: v.numpy() for k, v in params_from_jax(params4, cfg4).items()})
    lora, batch = grpo_inputs()
    grpo_args = ({p: {k: np.asarray(v) for k, v in ab.items()} for p, ab in lora.items()},
                 batch)
    ls = test_torch_llava.setup()
    llava_weights = root / "llava.npz"
    np.savez(llava_weights, **{k: v.numpy() for k, v in params_from_jax(ls.params,
                                                                        ls.cfg_t).items()})
    llava_args = (ls.cfg_t, ls.cc_t, str(llava_weights), ls.prep_t)
    ranks = launch(torch_mesh_worker.run, WORLD, str(weights), _args(False), _args(True),
                   str(work), cli_args, LR, str(q4_weights), grpo_args, llava_args,
                   backend="gloo",
                   timeout_s=300)
    for r in ranks:
        r["workdir"] = str(work)
    return ranks


@functools.lru_cache(maxsize=None)
def grpo_inputs():
    """The adapters (JAX's draw, + 0.05 so that B is not zero) and a fixed
    GRPOBatch on the mesh checks' weights (test_torch_grpo.fixed_batch)."""
    cfg, _, _, _, params = train_setup()
    prep = jax_prepare_inputs(cfg, *_args(False)[:2], **_args(False)[2])
    lora = jax.tree_util.tree_map(lambda x: x + 0.05,
                                  jax_lora.make_lora_params(params, rank=LORA_RANK, seed=1))
    return lora, fixed_batch(SimpleNamespace(cfg=cfg, params=params, prep_j=prep))


@functools.lru_cache(maxsize=None)
def jax_grpo_step():
    """JAX's GRPO step on ``grpo_inputs``: (reference logprobs, metrics,
    gradients, the adapters after the step), as test_torch_grpo's."""
    cfg, _, _, _, params = train_setup()
    lora, bt = grpo_inputs()
    pcfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, lora_rank=LORA_RANK,
                                                             remat=True))
    jbatch = jax_grpo.GRPOBatch(**{k: jnp.asarray(v) for k, v in bt.items()})
    jref = jax_grpo.compute_ref_logps(JaxModel(cfg), params, jbatch)
    jbatch = jbatch._replace(ref_logps=jref)
    pmodel = JaxModel(pcfg)

    def loss_fn(lo):
        logps = jax_grpo._completion_logps(pmodel, jax_lora.insert_lora(params, lo), jbatch)
        cm = jbatch.completion_valid.astype(jnp.float32)
        return (jax_grpo.grpo_surrogate(logps, jbatch.advantages, cm)
                + 0.04 * jax_grpo.k3_kl(logps, jbatch.ref_logps, cm))

    grads = jax.grad(loss_fn)(lora)
    opt = optax.adamw(LR)
    jlora, _, metrics = jax_grpo.make_grpo_loss_step(pmodel, opt, 1.0, 0.04)(
        lora, opt.init(lora), params, jbatch)
    return np.asarray(jref), metrics, grads, jlora


@functools.lru_cache(maxsize=None)
def port_lora_trees():
    """One process's ``lora_tree`` (the port, unsharded) after
    ``insert_lora`` and after its GRPO step on the same inputs."""
    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.training import grpo
    from glimpseprune_torch.training.lora import insert_lora, lora_parameters, lora_tree
    from glimpseprune_torch.training.train_step import AdamW

    cfg, _, _, _, params = train_setup()
    lora, bt = grpo_inputs()
    pcfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, lora_rank=LORA_RANK,
                                                             remat=True))
    model = load_from_jax(params, cfg, device="cpu")
    insert_lora(model, {p: {k: torch.as_tensor(np.asarray(v)) for k, v in ab.items()}
                        for p, ab in lora.items()}, cfg=pcfg)
    before = lora_tree(model)
    batch = grpo.GRPOBatch(**{k: torch.as_tensor(v) for k, v in bt.items()})
    batch = batch._replace(ref_logps=grpo.compute_ref_logps(model, batch))
    grpo.make_grpo_loss_step(model, AdamW(lora_parameters(model), LR), 1.0, 0.04)(batch)
    return before, lora_tree(model)


@functools.lru_cache(maxsize=None)
def jax_compressed(method):
    cfg, params = jax_tier("none")
    prep = jax_prepare_inputs(cfg, *_args(False)[:2], **_args(False)[2])
    return JaxRunner(cfg, params).generate_compressed(
        prep, method, **torch_mesh_worker.compressor_kwargs(method))


@functools.lru_cache(maxsize=None)
def jax_generate(tier, do_selection, max_new):
    cfg, params = jax_tier(tier)
    prep = jax_prepare_inputs(cfg, *_args(False)[:2], **_args(False)[2])
    res = JaxRunner(cfg, params).generate(prep, max_new_tokens=max_new,
                                          do_selection=do_selection)
    return res, prep.img_valid


def test_mesh_layout(ranks):
    """Row-major ranks: rank = data index * 2 + model index."""
    for rank, r in enumerate(ranks):
        shape, d, m = r["mesh"]
        assert shape == {"data": 2, "model": 2}
        assert (d, m) == divmod(rank, 2)


def test_w8a8_row_parallel_bit_equal(ranks):
    """The sharded product equals the unsharded one bit for bit on every
    rank; the same shards with their local amax do not (row 0 rounds
    otherwise), so the whole-row scale is what makes it equal."""
    for r in ranks:
        w = r["w8a8"]
        np.testing.assert_array_equal(w["sharded"], w["unsharded"])
    assert any(not np.array_equal(r["w8a8"]["local_amax"][0], r["w8a8"]["unsharded"][0])
               for r in ranks)


@pytest.mark.parametrize("case", ["tiny", "k6"])
def test_w4a8_row_parallel_bit_equal(ranks, case):
    """The row-parallel W4A8 product (both scales over the whole
    contraction, the int32 sums all-reduced) equals the unsharded plain K6
    bit for bit on every rank, at a tiny shape and at M=160, K=1024, N=512,
    which ``matmul_int4_auto`` routes to K6 on the whole layer's shape; the
    same shards with their local scales do not."""
    for r in ranks:
        w = r["w4a8"][case]
        np.testing.assert_array_equal(w["sharded"], w["unsharded"])
        if case == "k6":
            np.testing.assert_array_equal(w["auto"], w["unsharded"])
    assert any(not np.array_equal(r["w4a8"][case]["local_scales"], r["w4a8"][case]["unsharded"])
               for r in ranks)


@pytest.mark.parametrize("do_selection", [True, False], ids=["pruned", "unpruned"])
@pytest.mark.parametrize("tier", ["none", "int8", "int4"])
def test_tp_generate_matches_jax(ranks, tier, do_selection):
    """Greedy tokens equal to the JAX runner's on one device and mask
    logits of the image tokens within 1e-4 (tests/test_sharding.py:26-84),
    on every rank."""
    want, img_valid = jax_generate(tier, do_selection, torch_mesh_worker.MAX_NEW)
    for r in ranks:
        got = r["generate"][(tier, do_selection)]
        np.testing.assert_array_equal(got["sequences"], want.sequences)
        np.testing.assert_array_equal(got["num_generated"], want.num_generated)
        if do_selection:
            np.testing.assert_array_equal(got["keep_img"], want.keep_img)
            np.testing.assert_allclose(got["mask_logits"][:, img_valid],
                                       want.mask_logits[:, img_valid], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tier", ["none", "int8", "int4"])
def test_tp_local_shapes_and_eager_decode(ranks, tier):
    """Each rank holds half of the heads (1 of 2 kv heads, the decode
    cache's), of the o_proj rows and of the vocab rows; the decode runs
    eagerly; the ViT's importance scores on the mesh (head means summed
    over the model axis) equal the unsharded model's within 1e-5."""
    width = 128 if tier == "int4" else 32  # half of q4_mesh_config's 256, the tiny's 64
    for r in ranks:
        s = r["generate"][(tier, "shapes")]
        assert s == {"kv_heads": 1, "decode_mode": "eager", "embed_rows": 256,
                     "o_proj_in": width, "q_proj_out": width}
        imp = r["generate"][(tier, "importance")]
        for got, want in zip(imp["sharded"], imp["unsharded"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_tp_int4_row_layers_are_sharded(ranks):
    """The (q4) mesh's row-parallel int4 decoder layers hold half of the
    contraction, repacked: o_proj and down_proj 128 of 256 rows (64
    packed) with their 2 scale rows of 64; the ViT's int4 proj stays whole
    with its unit."""
    want = {"o_proj": ("row", (64, 256), (2, 256)), "down_proj": ("row", (64, 256), (2, 256)),
            "vit_proj": (None, (16, 32), (2, 32))}
    for r in ranks:
        got = r["generate"][("int4", "int4_rows")]
        assert {k: v[1:] for k, v in got.items()} == want
        assert all(v[0] == "int4" for v in got.values())


@pytest.mark.parametrize("method", torch_mesh_worker.COMPRESSORS)
def test_tp_compressors_match_jax(ranks, method):
    """``generate_compressed`` on TP weights: JAX's one-device tokens, keep
    sets and prune ratios on every rank (visionzip and vscan through the
    ViT's importance scores on the mesh, pdrop's stages through the harvest
    gathered along the heads)."""
    want = jax_compressed(method)
    for r in ranks:
        got = r["compressed"][method]
        np.testing.assert_array_equal(got["sequences"], want.sequences)
        np.testing.assert_array_equal(got["num_generated"], want.num_generated)
        np.testing.assert_array_equal(got["prune_ratio"], want.prune_ratio)
        if method != "pdrop":
            np.testing.assert_array_equal(got["keep_img"], want.keep_img)


def test_tp_grpo_step_matches_jax(ranks):
    """A LoRA GRPO step on TP weights, every rank on the same fixed batch:
    the reference logprobs, the losses and every adapter's whole gradient
    (the replicated pieces' summed over the model axis) against JAX's step,
    within test_torch_grpo's 1e-4 of max |JAX|; the same on every rank."""
    jref, jm, jgrads, _ = jax_grpo_step()
    _, bt = grpo_inputs()
    for r in ranks:
        g = r["grpo"]
        assert_close(g["ref_logps"], jref, bt["completion_valid"])
        for k in ("reward_loss", "kd_loss", "grpo_total", "mean_advantage"):
            assert_close(g["metrics"][k], np.asarray(jm[k]))
        assert len(g["grads"]) == 2 * 7 * 4
        for name, grad in g["grads"].items():
            layer = int(name.split(".")[2])
            path = "text/layers/" + "/".join(name.split(".")[3:5]) + "/kernel"
            assert_close(grad, np.asarray(jgrads[path][name[-1]][layer]))
            np.testing.assert_array_equal(grad, ranks[0]["grpo"]["grads"][name])


def test_tp_grpo_update_matches_jax(ranks):
    """The whole adapters after the step (``lora_tree`` gathers the parts)
    move as JAX's do, within 1e-4 of max |JAX's update|; a column layer
    holds its half of ``lora_b``, a row layer its half of ``lora_a``."""
    _, _, _, jlora = jax_grpo_step()
    lora, _ = grpo_inputs()
    for r in ranks:
        g = r["grpo"]
        assert g["b_local"] == (LORA_RANK, 32) and g["a_local"] == (32, LORA_RANK)
        for path, ab in jlora.items():
            for key in ("a", "b"):
                start = np.asarray(lora[path][key])
                assert_close(g["lora"][path][key] - start, np.asarray(ab[key]) - start)


def test_tp_lora_either_order_and_save(ranks):
    """Adapters put in after ``shard_params`` and before it give the same
    policy logprobs; ``save_lora(lora_tree(model))`` on the mesh writes one
    process's adapters: bit-equal before the step, within the step's
    tolerance after it."""
    from glimpseprune_torch.persistence import load_lora

    before, after = port_lora_trees()
    _, bt = grpo_inputs()
    for rank, r in enumerate(ranks):
        first, second = r["grpo"]["orders"]
        np.testing.assert_array_equal(first, second)
        saved = load_lora(os.path.join(r["workdir"], f"lora_{rank}_before"))
        assert set(saved) == set(before)
        for path, ab in before.items():
            for key in ("a", "b"):
                assert torch.equal(saved[path][key], ab[key]), (path, key)
        saved = load_lora(os.path.join(r["workdir"], f"lora_{rank}_after"))
        for path, ab in after.items():
            for key in ("a", "b"):
                upd = (saved[path][key] - before[path][key]).numpy()
                assert_close(upd, (ab[key] - before[path][key]).numpy())


@pytest.mark.parametrize("do_selection", [True, False], ids=["pruned", "unpruned"])
def test_llava_tp_generate_matches_jax(ranks, do_selection):
    """LLaVA on the mesh (its decoder sharded, the CLIP towers and the
    projector whole): JAX's one-device tokens, keep sets and mask logits
    within 1e-4, on every rank."""
    s = test_torch_llava.setup()
    want = s.jrun.generate(s.prep_j, max_new_tokens=torch_mesh_worker.MAX_NEW,
                           do_selection=do_selection)
    for r in ranks:
        got = r["llava"][do_selection]
        np.testing.assert_array_equal(got["sequences"], want.sequences)
        np.testing.assert_array_equal(got["num_generated"], want.num_generated)
        if do_selection:
            img = s.prep_j.img_valid
            np.testing.assert_array_equal(got["keep_img"], want.keep_img)
            np.testing.assert_allclose(got["mask_logits"][:, img], want.mask_logits[:, img],
                                       rtol=1e-4, atol=1e-4)
        shapes = r["llava"]["shapes"]
        assert shapes["q_proj"] == (32, 64) and shapes["kv_heads"] == 2
        assert shapes["clip_q"] == (32, 32) and shapes["projector"] == (64, 64)
        assert not shapes["clip_sharded"]


def test_batcher_on_mesh_matches_jax(ranks):
    """The continuous batcher over TP weights, its prefill sharded over the
    data axis, gives JAX ``generate``'s tokens for both requests
    (tests/test_serving.py:135-167)."""
    want, _ = jax_generate("none", True, torch_mesh_worker.SERVE_NEW)
    expect = want.sequences[0]
    for r in ranks:
        s = r["serve"]
        assert s["sp_sharded"]
        for i in range(2):
            np.testing.assert_array_equal(s["sequences"][i], expect[: s["sequences"].shape[1]])
        assert (s["num_generated"] == torch_mesh_worker.SERVE_NEW).all()


def test_tp_dp_train_step_loss_matches_jax(ranks):
    """The whole batch's metrics on every rank (each data rank ran one of
    the two rows) against the JAX step on the whole batch."""
    want, _, _ = jax_train_step()
    for r in ranks:
        for key in METRIC_KEYS:
            np.testing.assert_allclose(r["train"]["metrics"][key], want[key], **LOSS_TOL,
                                       err_msg=key)


def test_tp_dp_train_step_grads_match_jax(ranks):
    """Every trainable gradient, summed over the data axis, against
    jax.grad on the whole batch, at test_torch_training's tolerance."""
    _, want, _ = jax_train_step()
    for r in ranks:
        got = r["train"]["grads"]
        assert set(got) == set(want)
        for name in sorted(want):
            w = want[name]
            np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)


def test_tp_dp_train_step_update_matches_jax(ranks):
    """The weights after one AdamW step against the JAX TrainState, at
    test_torch_training's tolerance for one step, equal on every rank."""
    _, grads, want = jax_train_step()
    start = torch_names({})
    for r in ranks:
        for name, p in r["train"]["params"].items():
            assert np.abs(want[name] - start[name]).max() > 0, name
            g = np.abs(grads[name])
            tol = 1e-6 + LR * np.minimum(1.0, 1e-4 * g.max() / np.maximum(g, 1e-30))
            assert (np.abs(p - want[name]) <= tol).all(), name
            np.testing.assert_array_equal(p, ranks[0]["train"]["params"][name])


def test_gather_objects_across_ranks(ranks):
    """Payloads of different sizes come back in rank order on every rank."""
    for rank, r in enumerate(ranks):
        m = r["multihost"]
        assert m["hosts"] == (WORLD, rank)
        assert [g["host"] for g in m["gathered"]] == list(range(WORLD))
        assert [len(g["payload"]) for g in m["gathered"]] == [10 + 100 * i
                                                             for i in range(WORLD)]


def test_all_hosts_agree_ok_across_ranks(ranks):
    """Every rank proceeds when all succeed; when rank 1 fails every rank
    sees it, and an OOM on rank 1 skips the step on every rank."""
    for r in ranks:
        m = r["multihost"]
        assert m["all_ok"] is True and m["one_failed"] is False
        assert m["oom_step"] == "skipped"


def test_gather_objects_too_large_raises_on_every_rank(ranks):
    for r in ranks:
        assert "too large" in r["multihost"]["too_large"]


def test_shard_for_host_and_merge_across_ranks(ranks):
    """Contiguous shards of 7 samples over 4 ranks, written per rank and
    merged on rank 0 in order, the duplicate record once."""
    assert [r["multihost"]["shard_ids"] for r in ranks] == [
        ["q0", "q1"], ["q2", "q3"], ["q4", "q5"], ["q6"]]
    m = ranks[0]["multihost"]
    assert m["merged_n"] == 7
    assert m["merged_ids"] == [f"q{i}" for i in range(7)]
    assert all(os.path.basename(p) == f"shard_{i}.jsonl" for i, p in enumerate(m["paths"]))


def test_train_gp_mesh_takes_a_step_on_every_rank(ranks):
    """``train_gp --mesh`` on 4 ranks builds the default mesh (model axis
    4: the tiny config's 2 kv heads keep its attention replicated, the MLPs,
    the vocab and the ViT shard), prints it, and takes one step with the
    same finite loss on every rank."""
    losses = []
    for rank, r in enumerate(ranks):
        c = r["train_cli"]
        assert f"mesh: {{'data': 1, 'model': 4}} (rank {rank}" in c["stdout"]
        assert c["steps"] == [1]
        losses.append(c["loss"][0])
    assert np.isfinite(losses).all() and len(set(losses)) == 1

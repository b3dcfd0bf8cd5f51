"""The port's (data, model) mesh (glimpseprune_torch/parallel/mesh.py)
against the JAX package's (glimpseprune_tpu/parallel/mesh.py).

In one process: the mesh shapes against JAX ``make_mesh`` on the suite's 8
virtual devices, the rule table, every leaf of the tiny config's JAX tree
(unquantized and int8) reassembled from the port's shards over a model
axis of 2, the batch split against JAX ``shard_batch``'s shards, and the
refusals ((q4), LLaVA).

Over one launch of 4 gloo CPU ranks as a 2 x 2 mesh (tests/torch_mesh_worker.py,
which imports no jax; weights arrive as an ``.npz``): the row-parallel W8A8
product bit-equal to the unsharded one, tensor-parallel (TP) ``generate``
pruned and unpruned in both weight tiers against the JAX runner on one
device, the continuous batcher over TP weights with sequence parallelism
over the data axis against JAX ``generate``, one TP x data-parallel train
step against JAX ``make_train_step`` on the whole batch, the multi-process
helpers across the ranks (JAX tests/multihost_worker.py) and
``train_gp --mesh``."""

import functools
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

import torch_mesh_worker
from glimpseprune_tpu.models.qwen2_5_vl.runner import GlimpsePruneRunner as JaxRunner
from glimpseprune_tpu.models.qwen2_5_vl.runner import prepare_inputs as jax_prepare_inputs
from glimpseprune_tpu.parallel import mesh as jax_mesh
from glimpseprune_tpu.quantization import quantize_int8 as jax_quantize_int8
from glimpseprune_tpu.quantization import quantized_config as jax_quantized_config
from test_torch_cli import model_args, write_inputs
from test_torch_sp import LR, _args, jax_train_step
from test_torch_training import LOSS_TOL, METRIC_KEYS, torch_names, train_setup

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


def _port_dim(key: str, full: torch.Tensor, cfg):
    """Where the port shards the leaf ``key`` over 2 ranks: JAX's dim after
    its divisibility drop, in the port's layout (a Dense kernel is the
    transposed weight; stacked layers are split); for an int8 scale [1, out]
    of a column-parallel kernel, its columns; the ViT's merger, which JAX
    shards, whole (parallel/mesh.py says why); -> (dim, per-head split)."""
    path = _jax_path(key, full.ndim)
    if path.startswith("visual/merger_"):
        return None, False
    stacked = key.startswith(("text.layers.", "visual.blocks."))
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


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_shards_reassemble_to_the_jax_leaves(tier):
    """Every leaf of the JAX tree: the two ranks' shards, put back together
    along the sharded dim (for the ViT qkv per (3, heads, D)), equal the
    unsharded port leaf, which is the JAX leaf (``params_from_jax``); a
    replicated leaf is whole on both ranks."""
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import load_from_jax, params_from_jax
    from glimpseprune_torch.parallel import Mesh, shard_params
    from glimpseprune_torch.quantization import quantized_config

    _, _, _, _, params = train_setup()
    cfg = tiny_test_config()
    if tier == "int8":
        cfg, params = quantized_config(cfg), jax_quantize_int8(params)
    full = params_from_jax(params, cfg)
    shards = []
    for rank in range(2):
        model = load_from_jax(params, cfg, device="cpu")
        shard_params(model, Mesh({"data": 1, "model": 2}, 0, rank))
        shards.append(model.state_dict())
    heads = cfg.vision.num_heads
    n_sharded = 0
    for key, want in full.items():
        dim, per_head = _port_dim(key, want, cfg)
        got = [s[key] for s in shards]
        if dim is None:
            for g in got:
                torch.testing.assert_close(g, want, rtol=0, atol=0, msg=key)
            continue
        n_sharded += 1
        assert all(g.shape[dim] == want.shape[dim] // 2 for g in got), key
        if per_head:
            split = lambda t: t.reshape(t.shape[:dim] + (3, -1, t.shape[dim] // 3 // (
                heads // 2)) + t.shape[dim + 1:])
            whole = torch.cat([split(g) for g in got], dim + 1).reshape(want.shape)
        else:
            whole = torch.cat(got, dim)
        torch.testing.assert_close(whole, want, rtol=0, atol=0, msg=key)
    n_layers = cfg.text.num_hidden_layers
    # q/k/v/o + gate/up/down per decoder layer (and the biases of q/k/v),
    # embedding and head, every ViT block's 5 kernels
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
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.models.llava import gp_model as tgp
    from glimpseprune_torch.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
    from glimpseprune_torch.parallel import Mesh, shard_params
    from glimpseprune_torch.quantization import quantize_model
    from test_torch_llava import tiny_configs

    mesh = Mesh({"data": 1, "model": 2}, 0, 0)
    model = quantize_model(Qwen2_5_VL_GP(tiny_test_config()), "int4")
    with pytest.raises(ValueError, match=r"\(q4\).*ROADMAP"):
        shard_params(model, mesh)
    cfg, cc = tiny_configs(tgp)
    with torch.device("meta"):
        llava = tgp.Llava_GP(cfg, cc)
    with pytest.raises(ValueError, match="LLaVA.*ROADMAP"):
        shard_params(llava, mesh)


def test_lora_and_sharding_refuse_each_other():
    """Adapters never meet a sharded layer: ``shard_params`` refuses a
    model that carries them, and ``attach_lora`` / ``insert_lora`` refuse a
    sharded one (a row-parallel forward has no adapter term)."""
    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.models.layers import Linear, attach_lora
    from glimpseprune_torch.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
    from glimpseprune_torch.parallel import Mesh, shard_params
    from glimpseprune_torch.training.lora import insert_lora

    mesh = Mesh({"data": 1, "model": 2}, 0, 0)
    adapted = Qwen2_5_VL_GP(tiny_test_config())
    attach_lora([adapted.text.layers[0].self_attn.q_proj], 2)
    with pytest.raises(ValueError, match="LoRA.*ROADMAP"):
        shard_params(adapted, mesh)
    model = shard_params(Qwen2_5_VL_GP(tiny_test_config()), mesh)
    for name in ("o_proj", "q_proj"):  # row- and column-parallel
        lin = getattr(model.text.layers[0].self_attn, name)
        assert isinstance(lin, Linear) and lin.tp is not None
        with pytest.raises(ValueError, match="LoRA.*ROADMAP"):
            attach_lora([lin], 2)
        assert lin.lora_a is None
    h = model.cfg.text.hidden_size
    tree = {"text/layers/self_attn/o_proj": {
        "a": np.zeros((model.cfg.text.num_hidden_layers, h, 2), np.float32),
        "b": np.zeros((model.cfg.text.num_hidden_layers, 2, h), np.float32)}}
    with pytest.raises(ValueError, match="LoRA.*ROADMAP"):
        insert_lora(model, tree)


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
    return launch(torch_mesh_worker.run, WORLD, str(weights), _args(False), _args(True),
                  str(work), cli_args, LR, backend="gloo", timeout_s=300)


@functools.lru_cache(maxsize=None)
def jax_generate(tier, do_selection, max_new):
    cfg, _, _, _, params = train_setup()
    if tier == "int8":
        cfg, params = jax_quantized_config(cfg), jax_quantize_int8(params)
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


@pytest.mark.parametrize("do_selection", [True, False], ids=["pruned", "unpruned"])
@pytest.mark.parametrize("tier", ["none", "int8"])
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


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_tp_local_shapes_and_eager_decode(ranks, tier):
    """Each rank holds half of the heads (1 of 2 kv heads, the decode
    cache's), of the o_proj rows and of the vocab rows; the decode runs
    eagerly; the ViT's importance scores refuse TP."""
    for r in ranks:
        s = r["generate"][(tier, "shapes")]
        assert s == {"kv_heads": 1, "decode_mode": "eager", "embed_rows": 256,
                     "o_proj_in": 32, "q_proj_out": 32}
        assert "not tensor-parallel" in r["generate"][(tier, "importance_refused")]


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

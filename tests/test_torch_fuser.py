"""The port's AttnFuser family (glimpseprune_torch/gp/fuser.py) against the
JAX fusers on the same weights: mask logits on every valid image slot for
V1 (conditioned), V2 (unconditioned) and Dummy, with windowed and global
fuser attention segments. The fuser's attention has a qk head dim twice
its v head dim, so it runs the flash kernel's Dqk != Dv flavour."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glimpseprune_tpu.config import tiny_test_config
from glimpseprune_tpu.gp import fuser as jax_fuser
from test_torch_inputs import make_batch_args

TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 sums taken in another order


@pytest.mark.parametrize("attn_fuse_global", [False, True])
@pytest.mark.parametrize("fuser_type", ["AttnFuserV1", "AttnFuserV2", "AttnFuserDummy"])
def test_fuser_mask_logits_match_jax(fuser_type, attn_fuse_global):
    import torch

    from glimpseprune_torch.convert import params_from_jax
    from glimpseprune_torch.gp import fuser as torch_fuser
    from glimpseprune_torch.models.qwen2_5_vl import inputs as torch_inputs

    cfg = tiny_test_config(attn_fuse_type=fuser_type, attn_fuse_global=attn_fuse_global)
    prompts, images, kwargs = make_batch_args(cfg, seed=2)
    prep = torch_inputs.prepare_inputs(cfg, prompts, images, **kwargs)
    geo = prep.fuser
    b, n = prep.img_valid.shape
    rng = np.random.default_rng(3)
    n_in = len(cfg.gp.selected_layers) * cfg.text.num_attention_heads
    # harvested rows are log-probabilities
    attn_map = np.log(rng.dirichlet(np.ones(n), size=(b, n_in)).transpose(0, 2, 1) + 1e-9)
    attn_map = attn_map.astype(np.float32)
    taps = [rng.standard_normal((b, n, cfg.vision.hidden_size)).astype(np.float32)
            for _ in cfg.gp.selected_visual_layers]
    geo_args = (geo.window_index, geo.reverse_index, geo.segment_ids, geo.pos_ids,
                prep.img_valid)

    jf = jax_fuser.make_fuser(cfg)
    j_args = [jnp.asarray(attn_map), [jnp.asarray(t) for t in taps]] + \
        [jnp.asarray(a) for a in geo_args]
    shapes = jax.eval_shape(jf.init, jax.random.PRNGKey(0), *j_args)
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    want = np.asarray(jf.apply(params, *j_args, group_ids=jnp.asarray(prep.img_group)))

    tf = torch_fuser.make_fuser(cfg)
    state = {k[len("attn_fuser."):]: v for k, v in
             params_from_jax({"attn_fuser": params.get("params", {})}, cfg).items()}
    tf.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = tf(torch.as_tensor(attn_map), [torch.as_tensor(t) for t in taps],
                 *[torch.as_tensor(a) for a in geo_args],
                 group_ids=torch.as_tensor(prep.img_group)).numpy()
    assert got.shape == want.shape == ((2 if fuser_type != "AttnFuserDummy" else 1), b, n)
    valid = prep.img_valid
    np.testing.assert_allclose(got[:, valid], want[:, valid], **TOL)

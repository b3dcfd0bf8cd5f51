"""``mask_logits`` at every image slot, pad slots included, against the JAX
runner with the JAX attention in its Pallas kernels (interpret mode).

The JAX fuser takes two conventions for a row that has no allowed key (a
pad image slot): its Pallas flash branch writes zeros, as the port does on
every device, and its XLA branch lets the row attend to itself
(``glimpseprune_tpu/gp/fuser.py``, ``ops/attention.py``). On the CPU under
``ATTENTION_IMPL="auto"`` JAX picks XLA, so the two packages then differ
at ``img_valid == False``; under ``"flash_interpret"`` both run the flash
convention and agree at every slot. The keep set never reads pad slots."""

import numpy as np
import pytest

from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from glimpseprune_tpu.ops import attention as jax_attention
from test_torch_inputs import make_setup

# fp32 on both sides, sums in another order (as test_torch_gp_model.py)
RTOL = 1e-4


@pytest.fixture
def flash_interpret():
    old = jax_attention.ATTENTION_IMPL
    jax_attention.ATTENTION_IMPL = "flash_interpret"
    yield
    jax_attention.ATTENTION_IMPL = old


def _mask_logits():
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    want = np.asarray(jax_runner.GlimpsePruneRunner(s.cfg, s.params).glimpse(s.prep_j)
                      .mask_logits, np.float32)
    got = GlimpsePruneRunner(s.cfg, s.tmodel).prefill(s.prep_t, do_selection=True)
    return got.mask_logits.float().numpy(), want, np.asarray(s.prep_t.img_valid)


def test_mask_logits_agree_at_every_slot_under_flash(flash_interpret):
    got, want, img_valid = _mask_logits()
    assert got.shape == want.shape and (~img_valid).any()  # the batch has pad slots
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= RTOL * scale
    assert np.abs(got[:, ~img_valid] - want[:, ~img_valid]).max() <= RTOL * scale


def test_xla_branch_differs_only_at_pad_slots():
    """Under JAX's XLA branch (``"xla"``, what ``"auto"`` picks on the CPU)
    the valid slots still agree and only the pad slots differ: the
    difference is JAX's pad-row convention, not the port's."""
    old = jax_attention.ATTENTION_IMPL
    jax_attention.ATTENTION_IMPL = "xla"
    try:
        got, want, img_valid = _mask_logits()
    finally:
        jax_attention.ATTENTION_IMPL = old
    scale = np.abs(want[:, img_valid]).max()
    assert np.abs(got[:, img_valid] - want[:, img_valid]).max() <= RTOL * scale
    assert np.abs(got[:, ~img_valid] - want[:, ~img_valid]).max() > 100 * RTOL * scale

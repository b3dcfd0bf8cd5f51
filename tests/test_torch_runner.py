"""The port's ``GlimpsePruneRunner.generate`` against the JAX runner's on the
same weights and inputs: identical greedy tokens, pruned and unpruned; and
the host-side eos / stop-sequence trimming."""

import numpy as np
import pytest

from glimpseprune_tpu.models.qwen2_5_vl.runner import GlimpsePruneRunner as JaxRunner
from test_torch_inputs import make_setup


@pytest.mark.parametrize("do_selection", [True, False])
def test_generate_matches_jax_tokens(do_selection):
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    want = JaxRunner(s.cfg, s.params).generate(s.prep_j, max_new_tokens=8,
                                               do_selection=do_selection)
    got = GlimpsePruneRunner(s.cfg, s.tmodel).generate(s.prep_t, max_new_tokens=8,
                                                       do_selection=do_selection)
    assert got.sequences.shape == (2, 8)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.num_generated, want.num_generated)
    if do_selection:
        np.testing.assert_array_equal(got.keep_img, want.keep_img)
        np.testing.assert_allclose(got.prune_ratio, want.prune_ratio)
    else:
        assert got.keep_img is None and got.prune_ratio is None


def test_trim_eos_and_stop_sequences():
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    runner = GlimpsePruneRunner(s.cfg, s.tmodel)
    eos = 99
    seqs = np.array([[5, 6, 7, 99, 8, 9], [1, 2, 3, 4, 5, 6], [3, 1, 2, 7, 1, 2]])
    out, n = runner._trim_eos(seqs.copy(), 6, eos, stop_sequences=[[1, 2]])
    np.testing.assert_array_equal(n, [4, 0, 1])
    np.testing.assert_array_equal(out[0], [5, 6, 7, 99, 99, 99])
    np.testing.assert_array_equal(out[2], [3, 99, 99, 99, 99, 99])
    assert runner._first_stop_match(np.array([4, 7, 8, 7, 8]), [[9], [7, 8]]) == 1
    assert runner._first_stop_match(np.array([4]), [[4, 5], []]) == -1

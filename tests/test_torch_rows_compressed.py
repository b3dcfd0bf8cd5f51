"""The five baseline compressors on multi-image and video rows
(tests/test_torch_rows.py's batches) through ``generate_compressed``,
against the JAX runner on the shared tiny weights.

Tolerances: greedy tokens, counts, keep sets and prune ratios identical."""

import pytest

from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from test_torch_compressors import METHODS, method_kwargs
from test_torch_gp_knobs import preps
from test_torch_inputs import make_setup
from test_torch_rows import ROWS, assert_same


@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("method", METHODS)
def test_compressed_generate_on_rows_matches_jax(method, rows):
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    prep_j, prep_t = preps(s.cfg, *ROWS[rows](s.cfg))
    kwargs = method_kwargs(method)
    want = jax_runner.GlimpsePruneRunner(s.cfg, s.params).generate_compressed(
        prep_j, method, **kwargs)
    got = GlimpsePruneRunner(s.cfg, s.tmodel).generate_compressed(prep_t, method, **kwargs)
    assert_same(got, want)

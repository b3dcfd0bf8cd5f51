"""Send times, the ramp, the tails and the rate on a synthetic serve
schedule."""

import numpy as np
import pytest

from gpbench import stats


def test_send_times_follow_completions():
    # C = 2: requests 0, 1 at t0; 2 when the first completes; 3 at the second
    sent = stats.send_times([4.0, 1.0, 3.0, 6.0], 2)
    assert sent.tolist() == [0.0, 0.0, 1.0, 3.0]


def test_latencies_leave_out_the_ramp():
    lat = stats.latencies(ttft=[0.1, 0.2, 1.3, 3.5], completion=[1.0, 3.0, 5.0, 6.0],
                          n_gen=[4, 4, 4, 4], clients=2)
    assert np.allclose(lat["ttft"], [0.3, 0.5])
    assert np.allclose(lat["tpot"], [(5.0 - 1.3) / 3, (6.0 - 3.5) / 3])


def test_p90_interpolates():
    assert stats.p90(range(11)) == pytest.approx(9.0)
    assert stats.p90([1.0, 2.0]) == pytest.approx(1.9)


def test_window_numbers_over_every_episode():
    ep = dict(ttft=[0.1, 0.2, 1.3, 3.5], completion=[1.0, 3.0, 5.0, 6.0], n_gen=[4, 4, 4, 4])
    out = stats.window_numbers([ep, ep], 2, 12.0)
    assert out["tokens"] == 32 and out["attempted"] == 8 and out["measured"] == 4
    assert out["gen_tok_s"] == pytest.approx(32 / 12.0)
    assert out["ttft_p90_ms"] == pytest.approx(1e3 * np.percentile([0.3, 0.5, 0.3, 0.5], 90))

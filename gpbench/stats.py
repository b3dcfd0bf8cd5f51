"""The closed loop's arithmetic: send times, the ramp, tails and rates.

An episode is one ``ContinuousBatcher.serve`` over N requests with C
slots. Its first C requests are sent at the episode's start (the ramp);
request k >= C is sent when a slot frees, which, with the batcher's FIFO
free list and in-order queue, is the (k - C)-th earliest completion of the
episode. Times are seconds from the episode's start, as ``serve`` gives
them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def send_times(completion: Sequence[float], clients: int) -> np.ndarray:
    """When each request of an episode was sent: 0 for the ramp, the
    (k - C)-th earliest completion for request k >= C."""
    done = np.sort(np.asarray(completion, dtype=float))
    n = len(done)
    sent = np.zeros(n)
    sent[clients:] = done[:max(n - clients, 0)]
    return sent


def latencies(ttft: Sequence[float], completion: Sequence[float], n_gen: Sequence[int],
              clients: int) -> Dict[str, np.ndarray]:
    """The measured requests' (index >= C) time to first token from their
    send time and time per output token after the first, in seconds."""
    ttft, completion = np.asarray(ttft, float), np.asarray(completion, float)
    n_gen = np.asarray(n_gen)
    sent = send_times(completion, clients)
    m = np.arange(len(ttft)) >= clients
    gaps = (completion - ttft)[m] / np.maximum(n_gen[m] - 1, 1)
    return {"ttft": (ttft - sent)[m], "tpot": gaps}


def p90(values: Sequence[float]) -> float:
    """The 90th percentile, linearly interpolated between order statistics."""
    return float(np.percentile(np.asarray(values, dtype=float), 90))


def window_numbers(episodes: List[dict], clients: int, window_s: float) -> Dict[str, float]:
    """Every end-to-end number of a window from its episodes ({ttft,
    completion, n_gen} each): the rate over all its tokens and time, the
    tails over all its measured requests."""
    ttft, tpot, tokens, attempted = [], [], 0, 0
    for ep in episodes:
        lat = latencies(ep["ttft"], ep["completion"], ep["n_gen"], clients)
        ttft.extend(lat["ttft"])
        tpot.extend(lat["tpot"])
        tokens += int(np.sum(ep["n_gen"]))
        attempted += len(ep["n_gen"])
    out = {"tokens": tokens, "attempted": attempted, "measured": len(ttft),
           "gen_tok_s": tokens / window_s}
    if ttft:
        out["ttft_p90_ms"] = p90(ttft) * 1e3
        out["tpot_p90_ms"] = p90(tpot) * 1e3
    return out

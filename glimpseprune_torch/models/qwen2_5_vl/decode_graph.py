"""Decode as replays of one captured step.

The port's counterpart of the JAX runner's ``jax.jit(chunk_fn,
donate_argnums=(3, 4, 5))`` (glimpseprune_tpu/models/qwen2_5_vl/runner.py:
1153-1166), which compiles ``decode_chunk``'s scan once and runs a chunk
on the device. Here ``StepGraph`` captures one
``Qwen2_5_VL_GP.decode_state_step`` over a ``DecodeState`` in a
``torch.cuda.CUDAGraph``, and a chunk of n steps is n replays with no host
read between them. The step reads its slot, positions and token from the
state's tensors, so one graph of the 28 layers serves every step and every
chunk size (a graph of a whole 1024-step chunk would hold ~10^6 nodes).
Sampling draws each step's uniform noise from the caller's generator into
the state's buffer before the replay: one launch outside the graph, which
holds no generator state. On a CPU model the same step runs eagerly
(``EagerSteps``), chosen by the model's device; on the card a capture or a
replay that fails raises, and the step never runs eagerly instead.

Capture: one warm-up step on the capture stream first (it builds the
kernel libraries, raises K4's shared-memory cap and creates the library
handles, none of which a capture may do), then the capture. Both advance
the state, which the caller then begins again (``DecodeState.begin``); the
cache slot the warm-up wrote is at write_start, masked as stale until a
real step writes it.

Launch counts: a kernel wrapper counts its launch in Python, which runs
once, at capture, and never at replay. A StepGraph takes the counts that
its capture added back out and adds them once per replay, so the wrappers'
counters stay true. Decode attention has no kernel; the int4 products (K4,
and K6 past K4's 128 rows) are the kernels a step can reach.

``DecodeGraphs`` holds a runner's graphs, keyed by what changes the
captured pointers or code: B and T, the cache tier, greedy or sampled, and
the caches' addresses and layouts where the caller owns them (the runner
keeps no reference to those: a new cache at the same address and layout is
the memory the graph writes). It keeps a few and drops the oldest. Its graphs share one memory pool, which holds one step's
temporaries: graphs replay one at a time on one stream, and what outlives
a step lives in its DecodeState, outside the pool. A runner decodes one
request at a time: two decodes of one key share the state. The
continuous batcher (serving.py) captures one StepGraph of its own, over
its own state, whose step counter is the batcher's global write cursor.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch

from glimpseprune_torch.models.qwen2_5_vl.gp_model import DecodeState, Qwen2_5_VL_GP
from glimpseprune_torch.ops.cuda.int4_matmul import matmul_int4, matmul_int4_prefill

MAX_GRAPHS = 4  # captured steps a runner keeps


def _launches() -> Dict[Tuple, int]:
    """{(wrapper, key): launches} of the kernels a decode step can reach."""
    return {(fn, k): v for fn in (matmul_int4, matmul_int4_prefill)
            for k, v in fn.launches.items()}


def _add_launches(counts: Dict[Tuple, int], times: int) -> None:
    for (fn, k), v in counts.items():
        fn.launches[k] += v * times


class EagerSteps:
    """Decode steps run eagerly over ``state`` (a model on the CPU)."""

    def __init__(self, model: Qwen2_5_VL_GP, state: DecodeState):
        self.model, self.state, self.logits = model, state, None

    @torch.inference_mode()
    def run(self, n: int, rng: Optional[torch.Generator] = None) -> None:
        """n steps; ``logits`` [B, V] is the last one's."""
        for _ in range(n):
            self.state.draw_noise(rng)
            self.logits = self.model.decode_state_step(self.state)


class StepGraph:
    """One decode step of ``model`` over ``state``, captured on ``stream``
    (into ``pool`` when given). ``logits`` [B, V] is the graph's output,
    the last replay's logits; ``capture_s`` the host seconds of the
    warm-up and the capture."""

    def __init__(self, model: Qwen2_5_VL_GP, state: DecodeState, stream: torch.cuda.Stream,
                 pool=None):
        self.model, self.state = model, state
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            model.decode_state_step(state)
            before = _launches()
            # not torch.cuda.graph, which empties the caching allocator
            # first: a device-wide sync, and cold allocations after it
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.logits = model.decode_state_step(state)
            finally:  # the capture launched nothing
                self.graph.capture_end()
                self.per_replay = {k: v - before.get(k, 0) for k, v in _launches().items()
                                   if v != before.get(k, 0)}
                _add_launches(self.per_replay, -1)
        # the warm-up's writes to the state precede the caller's next ones
        torch.cuda.current_stream(stream.device).wait_stream(stream)
        self.capture_s = time.perf_counter() - t0

    def run(self, n: int, rng: Optional[torch.Generator] = None) -> None:
        """n replays, each after its step's noise draw when sampling."""
        for _ in range(n):
            self.state.draw_noise(rng)
            self.graph.replay()
        _add_launches(self.per_replay, n)


class DecodeGraphs:
    """A runner's captured decode steps, at most MAX_GRAPHS, the least
    recently used dropped first, sharing one capture stream and pool."""

    def __init__(self, model: Qwen2_5_VL_GP):
        self.model = model
        self._graphs: "OrderedDict[tuple, StepGraph]" = OrderedDict()
        self._stream = self._pool = None

    def steps(self, key: tuple, make_state: Callable[[], DecodeState],
              begin: Callable[[DecodeState], None]) -> StepGraph:
        """The graph of ``key``, begun (``begin`` sets the state for this
        decode); a new key's state comes from ``make_state`` and is begun
        before its capture too, so that the warm-up writes at write_start."""
        graph = self._graphs.pop(key, None)
        if graph is None:
            while len(self._graphs) >= MAX_GRAPHS:
                self._graphs.popitem(last=False)
            state = make_state()
            begin(state)
            if self._stream is None:
                self._stream = torch.cuda.Stream(state.tok.device)
            graph = StepGraph(self.model, state, self._stream, self._pool)
            self._pool = graph.graph.pool()
        self._graphs[key] = graph
        begin(graph.state)
        return graph

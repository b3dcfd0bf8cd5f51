"""Continuous-batching serving scheduler for one card.

Counterpart of glimpseprune_tpu/serving.py (``ContinuousBatcher`` :56-285).
A request is admitted into the decode batch as soon as its prefill lands
and a slot is free, instead of waiting for a whole batch of prefills; eos
frees a slot early for the next request. On one device this trades a
bounded amount of extra decode work for a shorter time to the first token
and to each request's completion.

Design, as in the JAX package: ONE decode cache per batcher with a GLOBAL
write cursor shared by every slot, so one decode step serves every
admission.

  - a row admitted at global step s holds its prefix KV at [0, R), leaves
    the gap [R, R + s) masked in kv_valid, and writes at the cursor from
    then on; attention needs only the mask;
  - each slot's positions stay right through a base offset stored as
    (the row's last position - s), so base + 1 + global step is the row's
    next position at every step;
  - admission clears the slot's whole kv_valid lane first: other rows'
    steps have marked the cursor's slots valid in it.

Here that step is ``Qwen2_5_VL_GP.decode_state_step`` over the batcher's
own ``DecodeState``, whose ``step`` is the global cursor and whose
``write_start`` is R: on a CUDA model it is captured once per batcher as a
CUDA graph (decode_graph.StepGraph) and every decode step of every
``serve`` is a replay of it, with no host read inside a chunk; on a CPU
model it runs eagerly (``EagerSteps``). The batcher owns its caches and
state for its lifetime, allocated when it is built, so that the graph's
addresses stay valid; the JAX package allocates a new cache per ``serve``
(:177-178). A second ``serve`` begins the same state again and replays the
same graph. Admission (``DecodeState.admit``) writes the slot's rows on the
caller's stream, on which the replays run too, so a replay never reads a
half-written slot.

The host reads the card only where the JAX scheduler does: the admitted
token (time to first token) and each chunk's tokens and done flags.
"""

from __future__ import annotations

import inspect
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from glimpseprune_torch.models.layers import lora_state
from glimpseprune_torch.models.qwen2_5_vl.decode_graph import EagerSteps, StepGraph
from glimpseprune_torch.models.qwen2_5_vl.gp_model import DecodeState
from glimpseprune_torch.models.qwen2_5_vl.runner import check_binding
from glimpseprune_torch.ops.kv_cache import alloc_cache

PrefillOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# (logits [1, *, V], valid [1, R], position_ids [3, 1, R],
#  kv_k [L, 1, R, Hkv, D], kv_v [L, 1, R, Hkv, D])


class ContinuousBatcher:
    """Slot scheduler over a shared decode cache.

    runner: GlimpsePruneRunner (its model, config and device).
    capacity: decode batch slots.
    prefix_len: R, every admitted row's (padded) prefill length: GP's
        fixed-budget compaction makes it one number per config.
    max_new_tokens / inter_steps: tokens per request / decode steps per
        interleaved chunk (the latency-against-overhead knob: an admission
        costs the running rows nothing, but the batch as a whole runs
        n_admissions x inter_steps more steps than an aggregated batch).
    eos / temperature: the stop token; greedy at 0, else a Gumbel-max
        sample from the ``rng`` passed to ``serve``.
    max_requests: sizes the cache (a longer queue must be split across
        ``serve`` calls).
    """

    def __init__(self, runner, capacity: int, prefix_len: int, max_new_tokens: int,
                 inter_steps: int = 8, eos: int = -1, temperature: float = 0.0,
                 max_requests: int = 0):
        cfg = runner.cfg
        self.runner = runner
        self.capacity = int(capacity)
        self.R = int(prefix_len)
        self.n_dec = int(max_new_tokens)
        self.inter = int(inter_steps)
        self.eos = int(eos)
        self.temperature = float(temperature)
        self.need = (self.n_dec + self.inter - 1) // self.inter
        n_req = max(int(max_requests), self.capacity)
        waves = (n_req + self.capacity - 1) // self.capacity
        # schedule bound: every admission interleaves <= 1 chunk, plus
        # `need` drain chunks per wave
        self.total_chunks = n_req + waves * self.need + 1
        self.T = self.R + self.total_chunks * self.inter
        t = cfg.text
        shape = (t.num_hidden_layers, self.capacity, self.T, t.num_key_value_heads, t.head_dim)
        with torch.inference_mode():
            caches = [alloc_cache(shape, runner.model.dtype, runner.device, t.kv_cache_quant)
                      for _ in range(2)]
            self.state = DecodeState.alloc(*caches, self.total_chunks * self.inter,
                                           t.vocab_size, self.temperature > 0)
        self._steps = self._lora = None

    def _begin(self) -> None:
        """Every slot free, the cursor at step 0 (slot R)."""
        st = self.state
        st.kv_valid.zero_()
        st.begin(torch.zeros_like(st.tok), torch.zeros_like(st.last_pos), self.R, self.eos,
                 self.temperature)

    def _decode_steps(self):
        """The batcher's decode step: captured on the first call on a CUDA
        model (a capture that fails raises), run eagerly on a CPU model.
        A captured step keeps the LoRA adapters' state (on, off, absent) it
        was captured with: a later call under another state raises."""
        model = self.runner.model
        if self._steps is None:
            self._begin()
            if self.runner.device.type != "cuda":
                self._steps = EagerSteps(model, self.state)
            else:
                self._lora = lora_state(model.text)
                self._steps = StepGraph(model, self.state, torch.cuda.Stream(self.runner.device))
        elif self._lora is not None and lora_state(model.text) != self._lora:
            raise ValueError("the batcher's decode step was captured with the LoRA adapters "
                             f"in state {self._lora}, not {lora_state(model.text)}")
        return self._steps

    @torch.inference_mode()
    def warm(self, prefill_out: PrefillOut) -> None:
        """Capture the decode step and run one admission and one chunk on
        the batcher's state (which ``serve`` begins again), so that a timed
        ``serve`` captures nothing."""
        steps = self._decode_steps()
        logits, valid, pos, kv_k, kv_v = prefill_out
        self._begin()
        self.state.admit(0, kv_k, kv_v, valid, logits, pos, 0, self.temperature,
                         torch.Generator(self.runner.device).manual_seed(0))
        steps.run(self.inter, torch.Generator(self.runner.device).manual_seed(0))
        self.state.toks.cpu()

    @torch.inference_mode()
    def serve(self, prefills: Sequence[Callable[[], PrefillOut]],
              rng: torch.Generator = None):
        """Run the admission loop over a queue of prefill thunks (JAX
        :152-285).

        Each thunk runs one request's B=1 prefill and returns the
        PrefillOut tuple, or is a generator (``vanilla_prefill_chunked_steps``
        whose return value is sliced to one row) that yields between
        prefill chunks, where running rows decode one chunk while budget
        allows. Thunks run lazily as slots open. rng: a torch.Generator on
        the model's device for sampling (None: seed 0). Returns (sequences
        [N, max_new_tokens] int64, n_generated [N], ttft_s [N],
        completion_s [N]): sequences eos-trimmed as ``generate`` trims
        them; times are host seconds from the loop's start, with a host
        read at every admission (the first token on the host) and after
        every decode chunk."""
        n_req = len(prefills)
        waves = (n_req + self.capacity - 1) // self.capacity
        if n_req + waves * self.need + 1 > self.total_chunks:
            raise ValueError(
                f"{n_req} requests overrun the cache schedule bound "
                f"({self.total_chunks} chunks); raise max_requests or split the queue")
        check_binding(self.runner.cfg, self.runner.model)
        B, inter, need = self.capacity, self.inter, self.need
        steps, st = self._decode_steps(), self.state
        self._begin()
        if rng is None:
            rng = torch.Generator(self.runner.device).manual_seed(0)
        t0 = time.perf_counter()

        seqs = np.full((n_req, need * inter), self.eos, dtype=np.int64)
        ttft = np.zeros(n_req)
        completion = np.zeros(n_req)
        slot_req = [-1] * B          # the request occupying each slot
        admit_chunk = [0] * B
        free = list(range(B))
        pending = list(range(n_req))
        live: List[int] = []         # occupied slots
        gchunk = 0

        def run_chunk():
            """One interleaved decode chunk and the slots' bookkeeping."""
            nonlocal gchunk
            steps.run(inter, rng)
            toks = st.toks[:, gchunk * inter:(gchunk + 1) * inter].cpu().numpy()
            done = st.done.cpu().numpy()
            gchunk += 1
            now = time.perf_counter() - t0
            for slot in list(live):
                req, c0 = slot_req[slot], admit_chunk[slot]
                seqs[req, (gchunk - 1 - c0) * inter:(gchunk - c0) * inter] = toks[slot]
                if gchunk - c0 >= need or bool(done[slot]):
                    completion[req] = now
                    live.remove(slot)
                    free.append(slot)

        def budget_left():
            """Whether one more interleaved chunk leaves room for the
            chunks still owed: one fall-through per unadmitted request, up
            to `need` per unadmitted wave, and the live rows' concurrent
            drain (their remaining chunks overlap: the max, not the sum)."""
            n_unadmitted = len(pending) + 1
            waves_left = (n_unadmitted + B - 1) // B
            live_rem = max((need - (gchunk - admit_chunk[sl]) for sl in live), default=0)
            reserved = n_unadmitted + waves_left * need + live_rem
            return gchunk + reserved + 1 <= self.total_chunks

        while pending or live:
            if pending and free:
                req = pending.pop(0)
                slot = free.pop(0)
                out = prefills[req]()
                if inspect.isgenerator(out):
                    # chunked admission: one decode chunk at every prefill
                    # chunk boundary while the schedule's budget allows
                    while True:
                        try:
                            next(out)
                        except StopIteration as stop:
                            out = stop.value
                            break
                        if live and budget_left():
                            run_chunk()
                rlogits, rvalid, rpos, ck, cv = out
                if rvalid.shape[0] != 1:
                    raise ValueError(f"admission takes one row, got B={rvalid.shape[0]} "
                                     "(slice the prefill output per request)")
                if rvalid.shape[1] > self.R:
                    raise ValueError(f"a prefix of {rvalid.shape[1]} slots overruns "
                                     f"prefix_len={self.R}")
                # the first token's draw precedes the chunks' draws, as in
                # runner._run_decode: a capacity-1 batcher reproduces
                # generate()'s sampled tokens
                st.admit(slot, ck, cv, rvalid, rlogits, rpos, gchunk * inter, self.temperature,
                         rng)
                first = int(st.tok[slot])  # host read: the first token
                ttft[req] = time.perf_counter() - t0
                slot_req[slot] = req
                admit_chunk[slot] = gchunk
                live.append(slot)
                if first == self.eos:  # a degenerate instant-eos request
                    completion[req] = ttft[req]
                    live.remove(slot)
                    free.append(slot)
                # fall through: one decode chunk between admissions
            if not live:
                continue
            run_chunk()

        seqs, n_gen = self.runner._trim_eos(seqs, self.n_dec, self.eos)
        return seqs, n_gen, ttft, completion

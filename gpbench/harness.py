"""One run of one cell: set-up, the measured window, the traced episode,
the check against the reference, and the result.

Everything that belongs to a cell is data found by name under the
benchmark's folder: ``workloads/<cell>.json`` (its configuration, its
traffic, the pool of distinct requests, the episode's length and the limits
of the comparison), ``configs/<config>.json`` (the model section,
its tier, its source) and ``traffic/<traffic>.json`` (sizes, clients,
tokens). Metrics are readers in ``metrics/<metric>.py``, each a ``read(run)``
over the ``Run`` this module fills, returning None where it finds nothing
to read.

The program is driven through its public entries only: the HF converter
and ``init_random`` (weights), ``quantized_config`` (the tier),
``prepare_inputs``, ``GlimpsePruneRunner.prefill`` and
``ContinuousBatcher``. The window is back-to-back ``serve`` episodes of a
closed loop of C clients (C = the batcher's slots) while ``seconds`` have
not run out; it starts after every shape the cell uses has run once.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gpbench import flops, stats, traffic, trace, weights

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "glimpseprune_tpu")
K1_KERNEL, K2_KERNEL = "window_attention_kernel", "flash_fwd_kernel"
JUDGE_REQUESTS = 6  # distinct requests of a window the reference judges
TRACE_ADMISSIONS = 4  # admissions after the ramp that the traced episode covers


def note(msg: str) -> None:
    print(f"gpbench: {msg}", file=sys.stderr, flush=True)


def load(root: Path, kind: str, name: str) -> dict:
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclass
class Spec:
    name: str
    cell: dict
    config: dict
    traffic: dict


def spec(name: str, root: Path = ROOT) -> Spec:
    cell = load(root, "workloads", name)
    return Spec(name, cell, load(root, "configs", cell["config"]),
                load(root, "traffic", cell["traffic"]))


def readers(root: Path = ROOT) -> Dict[str, object]:
    """{metric name: its reader module} of every file in metrics/."""
    out = {}
    for path in sorted((Path(root) / "metrics").glob("*.py")):
        sp = importlib.util.spec_from_file_location(f"gpbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(sp)
        sp.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def cell_metrics(name: str, traced: bool, found: Dict[str, object],
                 benchmark: Optional[dict]) -> List[str]:
    """The metrics a run of the cell prints: with ``--trace 0`` its
    end-to-end metrics, with ``--trace 1`` its per-layer ones, as
    BENCHMARK.json lists them; for a cell it does not list, every reader of
    that kind."""
    kind = "per_layer" if traced else "end_to_end"
    cells = [w["name"] for w in (benchmark or {}).get("workloads", [])]
    if benchmark is None or name not in cells:
        return [m for m, mod in found.items() if mod.KIND == kind]
    return [m["name"] for m in benchmark[kind]]


# ---- the device, guarded so that a CPU rehearsal runs the same code

def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def allocated(dev: torch.device) -> Optional[int]:
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None


@dataclass
class Episode:
    order: List[int]
    ttft: np.ndarray = None
    completion: np.ndarray = None
    n_gen: np.ndarray = None
    seqs: np.ndarray = None
    steps: int = 0
    spans: List[float] = field(default_factory=list)


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    spec: Spec
    seed: int
    traced: bool
    device: torch.device
    tier: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    peak_bytes: Optional[int] = None
    kv_bytes: Optional[int] = None
    episodes: List[Episode] = field(default_factory=list)
    shapes: List[dict] = field(default_factory=list)  # per pool request
    kept: Dict[int, int] = field(default_factory=dict)  # pool index -> image tokens kept
    trace: Optional[dict] = None

    @property
    def clients(self) -> int:
        return self.spec.traffic["clients"]

    def window_numbers(self) -> dict:
        eps = [dict(ttft=e.ttft, completion=e.completion, n_gen=e.n_gen) for e in self.episodes]
        return stats.window_numbers(eps, self.clients, self.window_s)


# ---- the program

def port_config(config: dict, tier: dict):
    """The program's ModelConfig of a configuration in a tier."""
    import dataclasses

    from glimpseprune_torch.config import ModelConfig
    from glimpseprune_torch.quantization import quantized_config

    cfg = ModelConfig.from_dict(config["model"])
    if tier.get("weights", "none") != "none":
        cfg = quantized_config(cfg, tier["weights"], **tier.get("knobs", {}))
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, kv_cache_quant=tier.get("kv_cache", "none"))).validate()


def int8_parts(tier: dict) -> List[str]:
    """The prefill products a tier runs in int8 (W8A8 or W4A8): the ViT's
    blocks and the text layers, where activations are quantized."""
    act = tier.get("knobs", {}).get("act_quant", "none")
    return ["vision_blocks", "text_prefill"] if act in ("int8", "prefill") else []


def build_program(sp: Spec, tier: dict, seed: int, dev: torch.device):
    """(config, runner) with the seed's weights, drawn here in the HF
    layout and handed over through the program's converter."""
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.convert import convert_hf_state_dict
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    cfg = port_config(sp.config, tier)
    hf, gp = weights.draw(sp.config["model"], seed, dev)
    base = {**convert_hf_state_dict(hf, cfg), **gp}
    del hf, gp
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = init_random(cfg, seed, dev, dtype, base=base)
    del base
    model.set_config(cfg)
    return cfg, GlimpsePruneRunner(cfg, model)


def shape_of(prep, model: dict) -> dict:
    """The shapes of one request's pruned prefill (for the work and bound
    arithmetic)."""
    le = model["gp"]["le_length"] if model["gp"]["le_layers"] else 0
    s_valid = int(prep.valid.sum())
    n_img = int(prep.n_img_tokens[0])
    return {"p": int(prep.vis_valid.sum()), "n_img": n_img, "s_pad": int(prep.input_ids.shape[1]),
            "s_valid": s_valid, "r_pad": int(prep.out_len), "text": s_valid - n_img - le}


# ---- one run

def run(name: str, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda", root: Path = ROOT, tier: Optional[dict] = None,
        benchmark: Optional[dict] = None) -> dict:
    """One run of cell ``name``; returns the result line as a dict (its
    ``checks`` last). ``tier`` replaces the configuration's (the control)."""
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.serving import ContinuousBatcher

    sp = spec(name, root)
    dev = torch.device(device)
    cell, tr, model = sp.cell, sp.traffic, sp.config["model"]
    tier = tier or sp.config["tier"]
    c, pool_n, n_ep = tr["clients"], cell["pool_requests"], cell["episode_requests"]
    r = Run(sp, seed, traced, dev, tier)

    reqs = traffic.make_requests(tr, model, seed, pool_n)
    cfg, runner = build_program(sp, tier, seed, dev)
    preps = [prepare_inputs(cfg, [q.prompt], [q.image], max_pixels=tr["max_pixels"])
             for q in reqs]
    r.shapes = [shape_of(p, model) for p in preps]
    note(f"{name}: program built, {pool_n} requests prepared, "
         f"{time.perf_counter() - t_start:.1f} s")

    judged = judge_sample(r)
    draws = np.random.default_rng([int(seed), 4])
    seen = dict.fromkeys(judged, 0)
    kept, held = {}, {}  # pool index -> its keep count; judged pool index -> its sample

    def prefill(i: int, ep: Optional[Episode] = None, at: Optional[tuple] = None):
        """One request's pruned prefill; ``at`` (episode, position) in the
        window. Of each judged request one occurrence in the window is held
        for the reference, drawn uniformly as they come (a reservoir of
        one), so that what the card holds does not grow with the requests
        served."""
        t0 = time.perf_counter()
        pre = runner.prefill(preps[i], do_selection=True)
        if at is not None:
            if i not in kept:
                kept[i] = pre.keep_img[0].sum()
            if i in seen:
                seen[i] += 1
                if draws.integers(seen[i]) == 0:
                    held[i] = (at, pre.keep_img[0].clone(), pre.mask_logits[-1, 0].clone(),
                                 pre.logits[0, -1].clone())
        if ep is not None and traced:
            sync(dev)
            ep.spans.append(time.perf_counter() - t0)
        return (pre.logits[:1], pre.valid[:1], pre.position_ids[:, :1], pre.kv_k[:, :1],
                pre.kv_v[:, :1])

    before = allocated(dev)
    batcher = ContinuousBatcher(runner, capacity=c, prefix_len=max(p.out_len for p in preps),
                                max_new_tokens=tr["output_tokens"], inter_steps=tr["inter_steps"],
                                eos=-1, max_requests=n_ep)
    r.kv_bytes = None if before is None else allocated(dev) - before
    # warm-up: one prefill of each image size, then the decode step's capture
    first = {}
    for i, q in enumerate(reqs):
        first.setdefault(q.image.shape, i)
    for i in first.values():
        warm = prefill(i)
    batcher.warm(warm)
    del warm
    sync(dev)

    def episode(k: int, hook: Optional[Callable[[int], None]] = None,
                n: int = n_ep) -> Episode:
        ep = Episode(traffic.episode_order(pool_n, n_ep, k, seed)[:n])

        def thunk(j: int):
            def go():
                if hook is not None:
                    hook(j)
                return prefill(ep.order[j], ep, None if hook else (k, j))
            return go

        seqs, n_gen, ttft, completion = batcher.serve([thunk(j) for j in range(n)])
        ep.seqs, ep.n_gen, ep.ttft, ep.completion = seqs, n_gen, ttft, completion
        ep.steps = int(batcher.state.step)
        return ep

    # ---- the window
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    r.setup_s = time.perf_counter() - t_start
    note(f"{name}: set-up {r.setup_s:.1f} s; window of {seconds} s")
    w0 = time.perf_counter()
    while not r.episodes or time.perf_counter() - w0 < seconds:
        r.episodes.append(episode(len(r.episodes)))
    sync(dev)
    r.window_s = time.perf_counter() - w0
    if dev.type == "cuda":
        r.peak_bytes = torch.cuda.max_memory_allocated(dev)
    note(f"{name}: window {r.window_s:.2f} s, {len(r.episodes)} episodes")

    if traced:
        r.trace = traced_episode(r, episode, dev)

    # ---- the check against the reference, the program freed first
    r.kept = {i: int(n) for i, n in kept.items()}
    picked = []
    for i in judged:
        (e, j), *outs = held.pop(i)
        ep = r.episodes[e]
        picked.append((reqs[i], [t.cpu() for t in outs], ep.seqs[j, :int(ep.n_gen[j])].tolist()))
    del batcher, runner, prefill, episode, kept, held
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, detail = check(sp, seed, dev, picked)

    found_readers = readers(root)
    names = cell_metrics(name, traced, found_readers, benchmark)
    metrics = {}
    for m in names:
        value = found_readers[m].read(r)
        if value is not None:
            metrics[m] = {"value": value, "unit": found_readers[m].UNIT}
    nums = r.window_numbers()
    failed = sum(int(np.sum(e.n_gen < tr["output_tokens"])) for e in r.episodes)
    correct = failed == 0 and all(v["value"] <= v["limit"] for v in checks.values())
    out = {"correct": bool(correct), "attempted": nums["attempted"], "failed": failed,
           "metrics": metrics, "device": device_block(r)}
    if traced and r.trace:
        out["breakdown"] = r.trace["breakdown"]
    out["judged"] = detail
    out["checks"] = checks
    return out


def judge_sample(r: Run) -> List[int]:
    """The pool requests the reference judges, drawn from the seed before
    the window: ``JUDGE_REQUESTS`` distinct ones, one of the largest image
    first (every episode sends the whole pool)."""
    rng = np.random.default_rng([int(r.seed), 2])
    pool = range(len(r.shapes))
    largest = max(sh["p"] for sh in r.shapes)
    big = [i for i in pool if r.shapes[i]["p"] == largest]
    chosen = [big[int(rng.integers(len(big)))]]
    rest = [i for i in pool if i != chosen[0]]
    n = min(JUDGE_REQUESTS, len(pool)) - 1
    return chosen + [rest[k] for k in rng.permutation(len(rest))[:n]]


def check(sp: Spec, seed: int, dev: torch.device, picked: List[tuple]):
    """({number: {value, limit}}, per-request detail): the reference's
    verdict on the sampled requests."""
    from gpbench.reference.judge import judge_request
    from gpbench.reference.model import Reference, fp32_only

    fp32_only()
    t0 = time.perf_counter()
    hf, gp = weights.draw(sp.config["model"], seed, dev)
    ref = Reference(sp.config["model"], hf, gp, dev)
    detail = [judge_request(ref, q, *outs, served) for q, outs, served in picked]
    del ref, hf, gp
    gc.collect()
    limits = sp.cell["limits"]
    checks = {k: {"value": max(d[k] for d in detail), "limit": limits[k]} for k in limits}
    note(f"reference over {len(picked)} requests in {time.perf_counter() - t0:.1f} s")
    return checks, detail


def device_block(r: Run) -> dict:
    dev = r.device
    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": r.peak_bytes}
    if r.traced and r.trace:
        out["busy_s"] = r.trace["busy_s"]
        out["window_s"] = r.trace["window_s"]
    return out


# ---- the traced episode

def traced_episode(r: Run, episode, dev: torch.device) -> Optional[dict]:
    """One more episode after the window, traced by torch.profiler from the
    admission after the ramp over ``trace_admissions`` admissions and the
    decode chunks between them, bounded on the device by marker kernels."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    c, k = r.clients, TRACE_ADMISSIONS
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def hook(j: int) -> None:
        if j == c:
            prof.start()
            torch.cuda._sleep(trace.MARK_CYCLES)
        elif j == c + k:
            torch.cuda._sleep(trace.MARK_CYCLES)
            torch.cuda.synchronize(dev)
            prof.stop()

    t0 = time.perf_counter()
    ep = episode(len(r.episodes), hook, c + k + 1)
    events = prof.events()
    device, host = [], []
    for e in events:
        if e.time_range.elapsed_us() <= 0:
            continue
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        (device if e.device_type == DeviceType.CUDA else host).append(span)
    note(f"trace: {len(device)} device and {len(host)} host records read in "
         f"{time.perf_counter() - t0:.1f} s")
    cut = trace.between_markers(device)
    if cut is None:
        note("trace: fewer than two markers; no device numbers")
        return None
    inside, window = cut
    busy = trace.busy_us(inside)
    traced_reqs = ep.order[c:c + k]
    return {"busy_s": busy / 1e6, "window_s": (window[1] - window[0]) / 1e6,
            "sums": trace.sums_by_name(inside), "requests": traced_reqs,
            "breakdown": trace.breakdown(inside, [h for h in host if h[2] >= window[0]
                                                  and h[1] <= window[1]], window)}


def attention_roofline(r: Run) -> Optional[float]:
    """Sum over the traced prefills' K1 and K2 calls of each call's bound,
    over the device time of those kernels, in percent; None where the
    trace's kernel counts are not the calls the prefills make."""
    if not r.trace:
        return None
    model = r.spec.config["model"]
    want = {"K1": 0, "K2": 0}
    bound = 0.0
    for i in r.trace["requests"]:
        shape = dict(r.shapes[i], r_valid=r.shapes[i]["text"] + r.kept.get(i, 0))
        for kname, calls in flops.attention_calls(model, shape).items():
            want[kname] += len(calls)
            bound += sum(flops.bound_s(f, b) for f, b in calls)
    got = {"K1": [0.0, 0], "K2": [0.0, 0]}
    for name, (us, n) in r.trace["sums"].items():
        for kname, marker in (("K1", K1_KERNEL), ("K2", K2_KERNEL)):
            if marker in name:
                got[kname][0] += us
                got[kname][1] += n
    if any(got[kk][1] != want[kk] for kk in want):
        note(f"roofline: kernel counts {({kk: v[1] for kk, v in got.items()})} "
             f"are not the calls {want}; not measured")
        return None
    device_s = (got["K1"][0] + got["K2"][0]) / 1e6
    return 100.0 * bound / device_s if device_s > 0 else None


def window_flops_time(r: Run) -> Optional[float]:
    """Seconds the window's work would take at the card's peaks: every
    prefill (int8 products at the int8 peak where the tier runs them so)
    and every decode step of every request over its valid context."""
    model = r.spec.config["model"]
    int8 = int8_parts(r.tier)
    total = 0.0
    for ep in r.episodes:
        for j, i in enumerate(ep.order):
            kept = r.kept.get(i)
            if kept is None:
                return None
            shape = dict(r.shapes[i], r_valid=r.shapes[i]["text"] + kept)
            w = flops.prefill_work(model, shape, int8)
            total += w["bf16"] / flops.PEAK_BF16_FLOPS + w["int8"] / flops.PEAK_INT8_OPS
            total += flops.decode_work(model, shape["r_valid"], int(ep.n_gen[j])) \
                / flops.PEAK_BF16_FLOPS
    return total

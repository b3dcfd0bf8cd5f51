"""Throughput / latency load test of an LLM-judge endpoint; counterpart of
tools/judge_loadtest.py (reference test_api.py:17-60, threaded).

``--threads`` threads each send ``--requests-per-thread`` judge requests
(the prompt ``evalsuite.judge.LLMClient.score`` sends) and the tool prints
one JSON line: requests, errors, wall_s, throughput_rps, latency_p50_s,
latency_max_s.

A request is an error when it fails (connection, HTTP status, a reply
that is not a chat completion) or when its reply holds no single
"score: <x>" (``judge.extract_score``'s rule). ``LLMClient.score`` reads
both as a score of 0.0, as the reference judge does, so the JAX tool,
which checks the score it returns, counts no error against a broken judge;
this one goes through ``LLMClient.chat`` and counts them.

  python -m glimpseprune_torch.tools.judge_loadtest --judge-url http://127.0.0.1:8000/v1
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import threading
import time
from typing import Optional, Sequence


def judge_once(client, query: str, completion: str, answer: str) -> float:
    """One judge request as ``LLMClient.score`` makes it -> its score;
    raises where the request fails or the reply holds no single score."""
    from glimpseprune_torch.evalsuite.judge import PROMPT, SYS_PROMPT

    reply = client.chat([{"role": "system", "content": SYS_PROMPT},
                         {"role": "user", "content": PROMPT.format(query, answer, completion)}])
    found = re.findall(r"score: ([\d\.]+)", reply.lower())
    if len(found) != 1:
        raise ValueError(f"no single score in the judge's reply {reply[:80]!r}")
    return min(max(float(found[0]), 0.0), 1.0)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the load test; returns the record it prints."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--judge-url", required=True)
    ap.add_argument("--judge-model", default="judge")
    ap.add_argument("--api-key", default="EMPTY")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--requests-per-thread", type=int, default=4)
    args = ap.parse_args(argv)

    from glimpseprune_torch.evalsuite.judge import LLMClient

    client = LLMClient(args.judge_url, args.api_key, args.judge_model)
    latencies, errors = [], [0]
    lock = threading.Lock()

    def worker(tid):
        for i in range(args.requests_per_thread):
            t0 = time.perf_counter()
            try:
                judge_once(client, f"What color is object {tid}-{i}?", "it is blue", "blue")
                ok = True
            except Exception:
                ok = False
            dt = time.perf_counter() - t0
            with lock:
                latencies.append(dt)
                if not ok:
                    errors[0] += 1

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(args.threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    n = len(latencies)
    rec = {
        "requests": n,
        "errors": errors[0],
        "wall_s": round(wall, 2),
        "throughput_rps": round(n / wall, 2),
        "latency_p50_s": round(statistics.median(latencies), 3) if latencies else None,
        "latency_max_s": round(max(latencies), 3) if latencies else None,
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()

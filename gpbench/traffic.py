"""The one traffic generator: requests from a traffic file's parameters and
a seed.

A traffic file (``gpbench/traffic/<name>.json``) gives the image sizes
and the prompt's length; the special ids around the image marker come from
the configuration. Every seed gets the same set of sizes (each size equally
often over a pool whose length the cell gives) in an order of its own, and
every episode sends the pool in an order drawn from the seed and the
episode's index: a seed changes the order, the pixels, the prompt ids and
the weights, never the amount of work, so that two seeds' runs differ
little more than two runs of one seed. Pixels are uint8 noise; prompt ids
are drawn below the configuration's lowest special id (the stand-in
tokenizer's range).
"""

from __future__ import annotations

from typing import List

import numpy as np

from gpbench.reference.model import Request

LO = 5  # the lowest ordinary id


def _ordinary_hi(model: dict) -> int:
    special = [model[k] for k in ("image_token_id", "video_token_id", "vision_start_token_id",
                                  "vision_end_token_id", "eos_token_id", "pad_token_id")]
    return min([model["text"]["vocab_size"]] + [i for i in special if i >= LO])


def size_order(traffic: dict, n: int, seed: int) -> List[List[int]]:
    """n image sizes: the traffic's sizes, each equally often, in the
    seed's order."""
    sizes = traffic["image_sizes"]
    if n % len(sizes):
        raise ValueError(f"a pool of {n} requests does not hold the {len(sizes)} sizes equally")
    out = [list(s) for s in sizes] * (n // len(sizes))
    return [out[i] for i in np.random.default_rng([int(seed), 1]).permutation(n)]


def make_requests(traffic: dict, model: dict, seed: int, n: int) -> List[Request]:
    """n distinct requests from the seed: an image of a traffic size and a
    prompt of ``prompt_tokens`` text ids split around the vision markers."""
    rng = np.random.default_rng([int(seed), 0])
    hi = _ordinary_hi(model)
    half = traffic["prompt_tokens"] // 2
    out = []
    for h, w in size_order(traffic, n, seed):
        image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ids = rng.integers(LO, hi, traffic["prompt_tokens"]).tolist()
        prompt = ids[:half] + [model["vision_start_token_id"], model["image_token_id"],
                               model["vision_end_token_id"]] + ids[half:]
        out.append(Request(image, prompt))
    return out


def episode_order(pool: int, n: int, episode: int, seed: int) -> List[int]:
    """The pool's requests in the order episode ``episode`` of the seed's
    run sends them: n // pool permutations of the pool, one after
    another."""
    if n % pool:
        raise ValueError(f"an episode of {n} requests does not hold the pool of {pool} whole")
    rng = np.random.default_rng([int(seed), 3, episode])
    return [int(i) for _ in range(n // pool) for i in rng.permutation(pool)]

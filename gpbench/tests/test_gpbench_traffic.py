"""The traffic generator: the same seed gives the same requests, every seed
the same work in an order of its own."""

from collections import Counter

import numpy as np

from gpbench import harness, traffic


def _spec():
    return harness.spec("qwen2_5_vl_7b.q8.hires_vqa")


def test_same_seed_same_requests():
    sp = _spec()
    a = traffic.make_requests(sp.traffic, sp.config["model"], 2 ** 31 + 11, 8)
    b = traffic.make_requests(sp.traffic, sp.config["model"], 2 ** 31 + 11, 8)
    for x, y in zip(a, b):
        assert x.prompt == y.prompt
        assert np.array_equal(x.image, y.image)


def test_seeds_share_the_work_in_orders_of_their_own():
    sp = _spec()
    a = traffic.make_requests(sp.traffic, sp.config["model"], 2 ** 31 + 5, 8)
    b = traffic.make_requests(sp.traffic, sp.config["model"], 6, 8)
    sizes = Counter(q.image.shape for q in a)
    assert len(sizes) == 4 and all(v == 2 for v in sizes.values())
    assert sizes == Counter(q.image.shape for q in b)
    assert [q.image.shape for q in a] != [q.image.shape for q in b]
    assert any(x.prompt != y.prompt for x, y in zip(a, b))
    assert not np.array_equal(a[0].image, b[0].image)


def test_prompt_shape():
    sp = _spec()
    m = sp.config["model"]
    q = traffic.make_requests(sp.traffic, m, 1, 4)[0]
    assert len(q.prompt) == sp.traffic["prompt_tokens"] + 3
    assert q.prompt.count(m["image_token_id"]) == 1
    assert max(t for t in q.prompt if t < m["vision_start_token_id"]) < m["pad_token_id"]


def test_episode_order_is_a_permutation_per_episode():
    o1 = traffic.episode_order(8, 16, 0, 2 ** 31 + 5)
    assert o1 == traffic.episode_order(8, 16, 0, 2 ** 31 + 5)
    assert sorted(o1) == sorted(list(range(8)) * 2)
    assert o1 != traffic.episode_order(8, 16, 1, 2 ** 31 + 5)
    assert o1 != traffic.episode_order(8, 16, 0, 6)

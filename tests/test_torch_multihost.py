"""The port's multi-process helpers (glimpseprune_torch/utils/multihost.py)
in one process, where they are the identity, against the JAX package's
(glimpseprune_tpu/utils/multihost.py, tests/test_evalsuite.py:220). Their
behaviour across 4 ranks is checked in test_torch_mesh.py, in the one
launch that file makes."""

import json

import pytest

from glimpseprune_tpu.utils import multihost as jax_multihost

OBJECTS = [{"a": 1}, [1, "two", None], "text", 3.5, True]


@pytest.mark.parametrize("obj", OBJECTS, ids=lambda o: type(o).__name__)
def test_gather_objects_single_process(obj):
    from glimpseprune_torch.utils.multihost import gather_objects

    assert gather_objects(obj) == [obj] == jax_multihost.gather_objects(obj)


def test_num_hosts_and_host_id_without_a_group():
    from glimpseprune_torch.utils.multihost import host_id, num_hosts

    assert (num_hosts(), host_id()) == (1, 0)
    assert (jax_multihost.num_hosts(), jax_multihost.host_id()) == (1, 0)


def test_merge_host_results_writes_the_jax_file(tmp_path):
    """The same shards give the same count and the same bytes: records
    de-duplicated by question_id in a stable order, a last line without a
    newline completed."""
    from glimpseprune_torch.utils.multihost import merge_host_results

    p1, p2, p3 = tmp_path / "s0.jsonl", tmp_path / "s1.jsonl", tmp_path / "s2.jsonl"
    p1.write_text('{"question_id": 1, "x": "a"}\n{"question_id": 2, "x": "b"}\n')
    p2.write_text('{"question_id": 2, "x": "b"}\n{"question_id": 3, "x": "c"}\n')
    p3.write_text('{"question_id": 4, "x": "d"}\n{"question_id": 1, "x": "e"}')
    paths = [str(p1), str(p2), str(p3)]
    port, jaxed = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    n = merge_host_results(paths, str(port))
    assert n == jax_multihost.merge_host_results(paths, str(jaxed)) == 4
    assert port.read_bytes() == jaxed.read_bytes()
    assert [json.loads(line)["question_id"] for line in open(port)] == [1, 2, 3, 4]

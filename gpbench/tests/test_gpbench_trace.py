"""The frozen trace arithmetic on synthetic intervals."""

import pytest

from gpbench import trace

M = trace.MARK


def test_busy_is_the_union():
    spans = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25)]
    assert trace.busy_us(spans) == 25


def test_only_spans_between_the_last_two_markers_count():
    dev = [("old", 0, 5), (M, 10, 11), ("x", 12, 20), (M, 30, 31), ("y", 32, 40),
           (M, 50, 51), ("late", 60, 70)]
    inside, window = trace.between_markers(dev)
    assert [s[0] for s in inside] == ["y"] and window == (31, 50)
    assert trace.between_markers([(M, 0, 1)]) is None


def test_sums_and_gaps():
    spans = [("k", 0, 2), ("k", 4, 5), ("j", 5, 9)]
    assert trace.sums_by_name(spans) == {"k": (3, 2), "j": (4, 1)}
    assert trace.gaps(spans, (0, 12)) == [(2, 4), (9, 12)]


def test_breakdown_names_the_host_activity_of_each_gap():
    dev = [("gemm", 0, 6), ("gemm", 8, 10)]
    host = [("serve", 0, 20), ("aten::copy_", 6, 8), ("aten::item", 10, 19)]
    out = trace.breakdown(dev, host, (0, 20))
    assert out["device_ops"] == [["gemm", pytest.approx(8e-6)]]
    assert dict(out["idle_gaps"]) == {"aten::item": pytest.approx(1e-5),
                                      "aten::copy_": pytest.approx(2e-6)}

"""Everything of a cell is found by name: a new cell is files only."""

import json

import pytest

from gpbench import harness
from gpbench.tests.common import tiny_root, tiny_run

BENCH = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())


def test_every_benchmark_entry_has_its_files():
    for w in BENCH["workloads"]:
        sp = harness.spec(w["name"])
        assert sp.cell["config"] == w["config"] and sp.cell["traffic"] == w["traffic"]
    for c in BENCH["configs"]:
        assert json.loads((harness.ROOT.parent / c["file"]).read_text())["name"] == c["name"]
    found = harness.readers()
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert found[m["name"]].KIND == kind and found[m["name"]].UNIT == m["unit"]


def test_metrics_chosen_by_the_benchmark():
    found = harness.readers()
    cell = BENCH["workloads"][0]["name"]
    assert set(harness.cell_metrics(cell, False, found, BENCH)) == {
        m["name"] for m in BENCH["end_to_end"]}
    assert set(harness.cell_metrics(cell, True, found, BENCH)) == {
        m["name"] for m in BENCH["per_layer"]}
    assert set(harness.cell_metrics("unlisted", False, found, BENCH)) == {
        m for m, mod in found.items() if mod.KIND == "end_to_end"}


def test_unknown_cell_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        harness.spec("no_such_cell", tiny_root(tmp_path))


def test_a_new_cell_is_files_only(tmp_path):
    root = tiny_root(tmp_path)
    tr = json.loads((root / "traffic" / "tiny_vqa.json").read_text())
    tr.update(name="tiny_square", image_sizes=[[112, 112]], output_tokens=8)
    (root / "traffic" / "tiny_square.json").write_text(json.dumps(tr))
    cell = json.loads((root / "workloads" / "tiny.tiny_vqa.json").read_text())
    cell.update(traffic="tiny_square", pool_requests=2, episode_requests=2)
    (root / "workloads" / "tiny.tiny_square.json").write_text(json.dumps(cell))
    out = tiny_run(root, "tiny.tiny_square")
    assert out["correct"] and out["attempted"] == 2
    assert all(d["tokens"] == 8 for d in out["judged"])

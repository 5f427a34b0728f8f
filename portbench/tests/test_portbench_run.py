"""Tiny cells driven end to end through the program's real gRPC server on
the CPU (the harness's look for a card is skipped: ``run_cell`` with
``device="cpu"``), checked for a well-formed result."""

import json

import pytest

from portbench import harness, spec
from tiny import make_root

SEED = 2**31 + 7  # seeds run past 32 signed bits


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("portbench")))


def _well_formed(result, root, cell, trace):
    assert list(result)[-1] == "checked"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    json.dumps(result)
    assert result["correct"] is True, result["checked"]
    assert result["failed"] == 0 and result["attempted"] > 0
    bench = spec.benchmark(root)
    kind = "per_layer" if trace else "end_to_end"
    for name, m in result["metrics"].items():
        entry = next(e for e in bench[kind] if e["name"] == name)
        assert m["unit"] == entry["unit"]
        assert isinstance(m["value"], float)
    for c in result["checked"].values():
        assert set(c) == {"value", "limit"}


def test_batch_cell_end_to_end(root):
    result = harness.run_cell("tiny.batch", SEED, 1.5, False, device="cpu", repo=root)
    _well_formed(result, root, "tiny.batch", False)
    names = {m["name"] for m in spec.metrics(spec.benchmark(root), "tiny.batch",
                                            "end_to_end")}
    # the CPU has no device memory to read
    assert names - set(result["metrics"]) <= {"peak_device_mem_gib"}
    assert result["metrics"]["qps"]["value"] > 0
    assert 0.5 < result["metrics"]["recall_at_10"]["value"] <= 1.0


@pytest.mark.parametrize("cell", ["tiny.search", "tiny.batch"])
def test_traced_cells(root, cell):
    result = harness.run_cell(cell, SEED + 1, 1.5, True, device="cpu", repo=root)
    _well_formed(result, root, cell, True)
    want = {"tiny.search": "rpc_overhead_ms.search",
            "tiny.batch": "rpc_overhead_ms.batch"}[cell]
    assert result["metrics"][want]["value"] > 0
    if cell == "tiny.search":
        assert result["metrics"]["latency_p95_ms.search"]["value"] > 0


def test_search_cell_reports_no_end_to_end_tail(root):
    """One-query latency stands per layer in the search cell, so its
    untraced line carries no ``latency_p95_ms``."""
    result = harness.run_cell("tiny.search", SEED + 3, 1.0, False, device="cpu",
                              repo=root)
    _well_formed(result, root, "tiny.search", False)
    assert "latency_p95_ms" not in result["metrics"]
    assert result["metrics"]["qps"]["value"] > 0


def test_same_seed_same_answers(root):
    from portbench import data

    cfg = spec.config(spec.benchmark(root),
                      spec.workload(spec.benchmark(root), "tiny.batch"), root)
    recipe = dict(cfg["data"], pool=cfg["query_pool"])
    a = data.make_rows(recipe, 4096, 128, SEED, "cpu")
    b = data.make_rows(recipe, 4096, 128, SEED, "cpu")
    c = data.make_rows(recipe, 4096, 128, SEED + 1, "cpu")
    assert (a[0] == b[0]).all() and (a[1] == b[1]).all()
    assert not (a[0] == c[0]).all()


def test_filtered_mix(root):
    """A mix's filter reaches the server and the reference alike: the
    answers hold only rows the filter keeps, and the check passes."""
    result = harness.run_cell("tiny.filter", SEED + 2, 1.0, False, device="cpu",
                              repo=root)
    _well_formed(result, root, "tiny.filter", False)
    assert result["checked"]["missing_hits"]["value"] == 0

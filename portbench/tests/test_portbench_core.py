"""A tiny core cell driven end to end through the program's real gRPC
server on the CPU (``modes/root.py``, ``rpcs/VectorSearchBatch.py``): the
sound run is correct and reads the core path's per-layer metrics; the
cell's controls and a search at ef=16 planted in the program's
``HnswIndex`` are not correct."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

from portbench import control, harness, spec
from tiny import REPO, make_root

CELL, REAL = "tiny.hnsw", "sift128.hnsw-batch"
CORE = {
    "name": "core-tiny", "mode": "root", "collection": "tiny", "rows": 8192,
    "dim": 128, "metric": "euclidean",
    "hnsw": {"m": 16, "ef_construction": 100, "ef": 128, "algorithm": "heuristic"},
    "fields": [{"name": "id", "type": "string", "primary_key": True},
               {"name": "row", "type": "integer"}],
    # two clusters of 4,096 rows: within one, a beam at ef=16 loses about a
    # fifth of the top 10 and one at ef=128 about a hundredth (more, smaller
    # clusters let ef=16 sweep a whole cluster and find every row)
    "data": {"recipe": "mixture", "centers": 2, "sigma": 0.35},
    "query_pool": 300, "source": "test", "reduced": [], "assumed": {},
}
MIX = {"rpc": "VectorSearchBatch", "batch": 64, "k": 10, "clients": 1,
       "client_processes": 1, "warmup_requests": 1, "check_answers": 256,
       "trace_seconds": 1}
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny checkout with a core configuration, its mix and a cell that
    takes the limits and the per-layer metrics of the real core cell."""
    root = make_root(str(tmp_path_factory.mktemp("core")))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "core-tiny.json"), "w") as f:
        json.dump(CORE, f)
    with open(os.path.join(pb, "traffic", "tiny-hnsw.json"), "w") as f:
        json.dump(MIX, f)
    shutil.copy(os.path.join(REPO, "portbench", "limits", f"{REAL}.json"),
                os.path.join(pb, "limits", f"{CELL}.json"))
    bench = spec.benchmark(root)
    bench["configs"].append({"name": "core-tiny", "source": "test", "reduced": [],
                             "file": "portbench/configs/core-tiny.json",
                             "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "core-tiny",
                               "traffic": "tiny-hnsw", "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def test_sound_run_is_correct(root):
    result = harness.run_cell(CELL, SEED, 1.5, False, device="cpu", repo=root)
    assert result["correct"] is True, result["checked"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["checked"]["missing_hits"]["value"] == 0
    assert result["metrics"]["qps"]["value"] > 0
    assert result["metrics"]["recall_at_10"]["value"] >= 0.95


SPANS_READ = ("descend_ms.hnsw", "beam_ms.hnsw", "flatten_ms.hnsw", "reply_ms.hnsw",
              "outside_server_ms.hnsw", "latency_p95_ms.hnsw", "ingest_s.hnsw",
              "build_s.hnsw")


def test_traced_run_reads_the_core_path(root):
    result = harness.run_cell(CELL, SEED + 1, 1.5, True, device="cpu", repo=root)
    assert result["correct"] is True, result["checked"]
    got = {n: m["value"] for n, m in result["metrics"].items()}
    for name in SPANS_READ:
        assert got[name] > 0, name
    assert got["build_s.hnsw"] < got["ingest_s.hnsw"]
    assert 1 <= got["beam_iters.hnsw"] <= max(2 * CORE["hnsw"]["ef"] // 16, 8)
    # the CPU run has no device trace
    assert "hnsw_roofline" not in got and "device_idle_share.hnsw" not in got


@pytest.mark.parametrize("name", ["tf32", "drop10"])
def test_controls_fail(root, name):
    (out,) = control.control_numbers(CELL, SEED, "cpu", repo=root, only=name)
    want = {"tf32": "score_gap", "drop10": "miss_share"}[name]
    assert want in out["fails"], out


def ef16(dep):
    """The collection searched at ef=16 in place of its 128."""
    hnsw = dep.engine._collections[dep.collection].hnsw
    hnsw.config = dataclasses.replace(hnsw.config, ef=16)


def test_search_at_ef16_fails_on_miss_share(root):
    result = harness.run_cell(CELL, SEED + 2, 1.0, False, device="cpu", repo=root,
                              hook=ef16)
    checked = result["checked"]
    assert result["correct"] is False, checked
    assert checked["miss_share"]["value"] > checked["miss_share"]["limit"]
    assert np.isfinite(checked["score_gap"]["value"])

"""A configuration, a traffic mix, a per-layer metric and a cell added as
files and entries are found by name, with no edit to a file that is
there."""

import json
import os

from portbench import harness, spec
from tiny import make_root

METRIC = '''
def read(rec):
    return float(len(rec["spans"]))
'''


def test_added_files_are_found(tmp_path):
    root = make_root(str(tmp_path))
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(os.path.join(root, "portbench")) for p in fs}
    pb = os.path.join(root, "portbench")
    cfg = json.load(open(os.path.join(pb, "configs", "edge-tiny.json")))
    cfg.update(name="edge-tiny-f16", quantization="F16", rows=4096)
    json.dump(cfg, open(os.path.join(pb, "configs", "edge-tiny-f16.json"), "w"))
    json.dump({"rpc": "SearchBatch", "batch": 16, "k": 5, "clients": 1,
               "client_processes": 1, "warmup_requests": 1, "check_answers": 64},
              open(os.path.join(pb, "traffic", "tiny-new.json"), "w"))
    with open(os.path.join(pb, "metrics", "spans_seen.py"), "w") as f:
        f.write(METRIC)
    json.dump({"control": "int4", "compare": {"missing_hits": {"limit": 0}}},
              open(os.path.join(pb, "limits", "tiny.new.json"), "w"))
    bench = spec.benchmark(root)
    bench["configs"].append({"name": "edge-tiny-f16", "source": "test",
                             "file": "portbench/configs/edge-tiny-f16.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.new", "config": "edge-tiny-f16",
                               "traffic": "tiny-new", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "spans_seen", "unit": "spans",
                               "better": "higher", "source": "program_span",
                               "layer": "gRPC server", "moves": "qps",
                               "workloads": ["tiny.new"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))

    result = harness.run_cell("tiny.new", 3, 1.0, True, device="cpu", repo=root)
    assert result["correct"] is True, result["checked"]
    assert result["metrics"]["spans_seen"]["value"] > 0
    assert set(result["checked"]) == {"failed_requests", "missing_hits"}
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, fs in os.walk(pb) for p in fs if "__pycache__" not in dp}
    assert all(after[p] == before[p] for p in before if p in after)

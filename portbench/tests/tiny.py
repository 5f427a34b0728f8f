"""A checkout of the benchmark at a size the CPU runs in seconds.

:func:`make_root` copies ``BENCHMARK.json`` and ``portbench/``'s data
files into a temporary directory and adds a tiny edge configuration,
three mixes and a cell of each; the harness then runs them
there with ``device="cpu"`` (the program's kernels take their plain
PyTorch versions). The Python modules are the repo's own.
"""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EDGE = {
    "name": "edge-tiny", "mode": "edge", "collection": "tiny", "rows": 8192,
    "dim": 768, "metric": "cosine", "quantization": "I8",
    "fields": [{"name": "id", "type": "string", "primary_key": True},
               {"name": "row", "type": "integer"}],
    "data": {"recipe": "mixture", "centers": 64, "sigma": 0.35},
    "query_pool": 300,
    "serving": {"scan_batch_max": 2048, "scan_batch_wait_ms": 2.0},
    "source": "test", "reduced": [], "assumed": {},
}
MIXES = {
    "tiny-batch": {"rpc": "SearchBatch", "batch": 64, "k": 10, "high_resource": True,
                   "clients": 2, "client_processes": 2, "warmup_requests": 1,
                   "check_answers": 256},
    "tiny-filter": {"rpc": "SearchBatch", "batch": 32, "k": 10, "high_resource": True,
                    "filter": {"field": "row", "op": "GTE", "int": 6144},
                    "clients": 1, "client_processes": 1, "warmup_requests": 1,
                    "check_answers": 128},
    "tiny-search": {"rpc": "Search", "batch": 1, "k": 10, "high_resource": True,
                    "clients": 4, "client_processes": 2, "warmup_requests": 1,
                    "check_answers": 256}
}
CELLS = {
    "tiny.batch": ("edge-tiny", "tiny-batch", "edge768.batch-hr"),
    "tiny.search": ("edge-tiny", "tiny-search", "edge768.search-c1"),
    "tiny.filter": ("edge-tiny", "tiny-filter", "edge768.batch-hr"),
}


def _dump(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(tmp: str) -> str:
    """A checkout under ``tmp`` with the tiny cells; each takes the limits
    of the real cell it stands for. Returns its path."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cfg in (EDGE,):
        path = f"portbench/configs/{cfg['name']}.json"
        _dump(os.path.join(root, path), cfg)
        bench["configs"].append({"name": cfg["name"], "source": "test", "file": path,
                                 "reduced": [], "why": "test"})
    for name, mix in MIXES.items():
        _dump(os.path.join(root, "portbench", "traffic", f"{name}.json"), mix)
    for cell, (cfg, mix, real) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": mix,
                                   "chips": 1, "why": "test"})
        shutil.copy(os.path.join(REPO, "portbench", "limits", f"{real}.json"),
                    os.path.join(root, "portbench", "limits", f"{cell}.json"))
        for kind in ("end_to_end", "per_layer"):
            for m in bench[kind]:
                if real in m.get("workloads", []):
                    m["workloads"].append(cell)
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root

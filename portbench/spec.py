"""Finds a cell's pieces by name.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; everything
else it uses is a file found by a name in that entry:

- its configuration: the ``file`` of the ``configs`` entry it names;
- its traffic mix: ``portbench/traffic/<traffic>.json``;
- the limits of its check: ``portbench/limits/<cell>.json``;
- its per-layer metrics: ``portbench/metrics/<metric>.py`` (a ``read``
  function of the traced run's record);
- the deployment of its configuration's ``mode``:
  ``portbench/modes/<mode>.py``;
- the RPC of its mix: ``portbench/rpcs/<rpc>.py``.

So a later change adds a configuration, a mix, a metric or a cell by
adding files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(repo: str = REPO) -> dict:
    return _json(os.path.join(repo, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config(bench: dict, cell: dict, repo: str = REPO) -> dict:
    for c in bench["configs"]:
        if c["name"] == cell["config"]:
            return _json(os.path.join(repo, c["file"]))
    raise KeyError(f"BENCHMARK.json has no config {cell['config']!r}")


def traffic(name: str, repo: str = REPO) -> dict:
    return _json(os.path.join(repo, "portbench", "traffic", f"{name}.json"))


def limits(cell_name: str, repo: str = REPO) -> dict:
    return _json(os.path.join(repo, "portbench", "limits", f"{cell_name}.json"))


def metrics(bench: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell_name``
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def load(kind: str, name: str, repo: str = REPO):
    """``portbench/<kind>/<name>.py`` as a module."""
    path = os.path.join(repo, "portbench", kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    modname = "portbench_" + kind + "_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

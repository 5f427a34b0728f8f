"""One run of one cell: set-up, the measured window, the check, the line.

1. Set-up (``setup_s``, from the start of ``python -m portbench.run`` to
   the moment every client is warm): the rows and the query pool on the
   device from the seed (``data.py``), the program's server built by its
   ``api/server.py`` and the rows ingested through the engine's bulk entry
   (``modes/<mode>.py``), the client processes spawned, connected and
   warmed up with a few requests of the cell's own shape each.
2. The window, ``--seconds`` long: the clients' closed loops. With
   ``--trace 1`` the methods the harness built are wrapped for spans, and
   one ``torch.profiler`` session, started before the window opens, is
   read over ``trace_seconds`` of it from a second after it opens.
3. After it: the device's peak memory read, the program's state freed,
   the sampled answers judged against the plain reference (``judge.py``),
   and one JSON line.

Everything the run writes lives in a temporary directory under ``TMPDIR``
(the edge object store, the core data directory and its commit log, the
query pool for the clients), removed at the end.
"""

from __future__ import annotations

import gc
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from portbench import data, judge, spec
from portbench.client import CALL_GRACE_S, ClientPool
from portbench.trace import (DeviceTrace, Tracer, busy_intervals, by_name,
                             label_gaps)

START_LEAD_S = 0.25   # the window opens this long after the clients are told
TRACE_LEAD_S = 1.0    # the traced part starts this long after the window opens
READY_TIMEOUT_S = 600
TOP = 10
GIB = float(1 << 30)
FORBIDDEN = ("jax", "jaxlib", "flax", "coltt_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def quiet_program_logs() -> None:
    """The program logs a line per request at INFO: it still formats each,
    into the null device, and its warnings still reach stderr, whose last
    lines belong to the check."""
    from coltt_tpu_torch.utils.logging import get_logger

    get_logger()
    root = logging.getLogger("coltt")
    for h in root.handlers:
        if isinstance(h, logging.StreamHandler):
            h.setStream(open(os.devnull, "w"))
    warn = logging.StreamHandler(sys.stderr)
    warn.setLevel(logging.WARNING)
    root.addHandler(warn)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def gen_dir() -> str:
    """The program's generated protobuf modules (its wire format)."""
    import coltt_tpu_torch.api as api

    return os.path.join(os.path.dirname(api.__file__), "gen")


def card(device: str, chips: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = "unknown"
    return out


def merge(outs: list) -> tuple[dict, dict, list]:
    """Every client's request records and answer samples, concatenated."""
    keys = ("sent", "done", "nq", "ok")
    recs = {k: np.concatenate([o[k] for o in outs if k in o]) for k in keys}
    recs["req"] = [t for o in outs if "req" in o for t in o["req"]]
    samples = [o["sample"] for o in outs if "sample" in o]
    sample = {k: np.concatenate([s[k] for s in samples])
              for k in ("pool", "count", "ids", "scores")}
    errors = [e for o in outs for e in o.get("errors", [])]
    return recs, sample, errors


def end_to_end(recs: dict, window: tuple, found: dict, peak: int,
               setup_s: float) -> dict:
    """The end-to-end numbers: ``qps`` (queries of the requests answered
    inside the window over its length), ``latency_p95_ms`` (every request
    sent in the window), ``recall_at_10``, ``peak_device_mem_gib`` and
    ``setup_s``."""
    t0, t1 = window
    ok = recs["ok"]
    in_window = ok & (recs["done"] <= t1)
    lat = (recs["done"] - recs["sent"])[ok]
    return {
        "qps": float(recs["nq"][in_window].sum() / (t1 - t0)),
        "latency_p95_ms": float(np.percentile(lat, 95) * 1e3) if lat.size else None,
        "recall_at_10": found.get("recall_at_10"),
        "peak_device_mem_gib": peak / GIB,
        "setup_s": setup_s,
    }


def traced_part(traffic: dict, t0: float, t1: float) -> tuple[float, float]:
    """The part of the window the profiler's record is read over: the mix's
    ``trace_seconds`` (at most a quarter of the window), from
    ``TRACE_LEAD_S`` after it opens."""
    span = min(float(traffic.get("trace_seconds", 5)), (t1 - t0) / 4)
    return t0 + TRACE_LEAD_S, t0 + TRACE_LEAD_S + span


def breakdown(profile: dict, spans: list) -> dict:
    lo, hi = profile["start"], profile["end"]
    ops = sorted(by_name(profile["device"], lo, hi).items(), key=lambda kv: -kv[1])
    busy = busy_intervals(profile["device"], lo, hi)
    edges = [lo] + [x for b in busy for x in b] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle = sorted(label_gaps(gaps, spans).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in ops[:TOP]],
            "idle_gaps": [[n, s] for n, s in idle[:TOP]]}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", repo: str = spec.REPO, hook=None,
             t_start: float | None = None) -> dict:
    """One run; returns the result line as a dict (``checked`` last)."""
    t_start = time.monotonic() if t_start is None else t_start
    import torch

    bench = spec.benchmark(repo)
    cell = spec.workload(bench, workload)
    config = spec.config(bench, cell, repo)
    traffic = spec.traffic(cell["traffic"], repo)
    limits = spec.limits(workload, repo)
    mode = spec.load("modes", config["mode"], repo)
    cuda = device == "cuda"
    quiet_program_logs()
    dev = card(device, int(cell["chips"]))

    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        t = time.monotonic()
        rows, pool = data.make_rows(dict(config["data"], pool=config["query_pool"]),
                                    config["rows"], config["dim"], seed, device)
        pool_path = os.path.join(work, "pool.npy")
        np.save(pool_path, pool)
        log(f"portbench: {workload} seed {seed}: rows {rows.shape} and pool "
            f"{pool.shape} in {time.monotonic() - t:.1f} s")
        tracer = Tracer() if trace else None
        dtrace = profile = None
        t = time.monotonic()
        dep = mode.Deployment(config, work, device, tracer)
        try:
            dep.ingest(rows)
            log(f"portbench: server and ingest in {time.monotonic() - t:.1f} s")
            if hook is not None:
                hook(dep)
            clients = ClientPool({
                "address": dep.address, "traffic": traffic, "seed": seed,
                "collection": dep.collection, "pool_path": pool_path,
                "seconds": seconds, "trace": bool(trace),
                "gen_dir": gen_dir(), "repo": repo,
                "sample_per_client": -(-int(traffic["check_answers"])
                                       // int(traffic["clients"])),
            }, int(traffic["client_processes"]), int(traffic["clients"]))
            try:
                clients.wait_ready(READY_TIMEOUT_S)
                setup_s = time.monotonic() - t_start
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                if trace and cuda:
                    dtrace = DeviceTrace()
                    dtrace.start()
                t0 = time.monotonic() + START_LEAD_S
                t1 = t0 + seconds
                clients.start(t0, t1)
                if dtrace is not None:
                    lo, hi = traced_part(traffic, t0, t1)
                    time.sleep(max(0.0, hi - time.monotonic()))
                    dtrace.stop()
                outs = clients.collect(seconds + CALL_GRACE_S + 120)
                if dtrace is not None:
                    # read once the window has closed: it takes the GIL
                    profile = dtrace.events(lo, hi)
            finally:
                clients.close()
            peak = torch.cuda.max_memory_allocated() if cuda else 0
        finally:
            dep.stop()
            if tracer is not None:
                tracer.close()
        k1_calls = dep.k1_calls if hasattr(dep, "k1_calls") else []
        del dep
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        recs, sample, errors = merge(outs)
        for e in errors[:5]:
            log(f"portbench: client error: {e}")
        attempted, failed = int(len(recs["sent"])), int((~recs["ok"]).sum())
        t = time.monotonic()
        found = judge.numbers(sample, pool, rows, int(traffic["k"]),
                              config["metric"], device, traffic.get("filter"))
        log(f"portbench: the check of {found.get('answers')} answers in "
            f"{time.monotonic() - t:.1f} s")
        correct, checked = judge.verdict(found, limits, attempted, failed)

    window = (t0, t1)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed}
    if not trace:
        values = end_to_end(recs, window, found, peak, setup_s)
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec.metrics(bench, workload, "end_to_end")
            if values.get(m["name"]) is not None}
    else:
        record = {"window": window, "requests": recs, "spans": tracer.spans,
                  "logs": tracer.logs,
                  "k1_calls": k1_calls, "profile": profile, "rpc": traffic["rpc"]}
        result["metrics"] = {}
        for m in spec.metrics(bench, workload, "per_layer"):
            value = spec.load("metrics", m["name"], repo).read(record)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value),
                                                "unit": m["unit"]}
        if profile is not None:
            busy = busy_intervals(profile["device"], profile["start"], profile["end"])
            dev["busy_s"] = sum(b - a for a, b in busy)
            dev["window_s"] = profile["end"] - profile["start"]
            result["breakdown"] = breakdown(profile, tracer.spans)
    dev["memory_peak_bytes"] = int(peak)
    result["device"] = dev
    result["answers"] = {k: v for k, v in found.items()
                         if k not in limits["compare"]}
    result["checked"] = checked
    return result

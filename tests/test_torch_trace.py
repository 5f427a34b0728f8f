"""The port's spans and counters (``coltt_tpu_torch/utils/trace.py``): the
ring, the clock, the counters under threads, the spans the served path
records over gRPC, and the ``/debug/trace`` endpoint."""

import json
import logging
import socket
import sys
import threading
import time
import tracemalloc
import urllib.request

import grpc
import numpy as np
import pytest

from coltt_tpu_torch.api.client import EdgeClient
from coltt_tpu_torch.api.server import build_servicer, create_server
from coltt_tpu_torch.index.schema import CollectionSchema, FieldSchema, FieldType
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.utils import trace
from coltt_tpu_torch.utils.config import Config

S = 10**9  # ns a second


def _fill(rec, n):
    """Span ``i`` is named ``s<i>`` and runs from i s to i + 0.5 s."""
    for i in range(n):
        rec.record(f"s{i}", None, i * S, i * S + S // 2)


@pytest.mark.parametrize("written", [3, 4, 5, 9])
def test_ring_overwrites_oldest_first(written):
    rec = trace.Recorder(capacity=4)
    assert rec.oldest() is None
    _fill(rec, written)
    held = [s[0] for s in rec.spans()]
    first = max(0, written - 4)
    assert held == [f"s{i}" for i in range(first, written)]
    # until it wraps, the ring holds everything from its first start; after,
    # everything that ended from the oldest held span's end on
    assert rec.oldest() == (first + 0.5 if written > 4 else 0.0)


@pytest.mark.parametrize("lo, hi, want", [
    (1.2, 2.7, [1, 2]),        # s1 ends inside, s2 lies inside
    (1.5, 1.5, [1]),           # a span's end touches the bound
    (1.6, 1.9, []),            # between two spans
    (-1.0, 0.0, [0]),
    (3.0, 99.0, [3, 4]),
    (float("-inf"), float("inf"), [0, 1, 2, 3, 4]),
])
def test_spans_clip_to_the_interval(lo, hi, want):
    rec = trace.Recorder(capacity=8)
    _fill(rec, 5)
    got = rec.spans(lo, hi)
    assert [s[0] for s in got] == [f"s{i}" for i in want]
    for name, method, thread, start, end in got:
        assert method is None and thread == threading.get_ident()
        assert end - start == pytest.approx(0.5)


def test_spans_are_stamped_on_time_monotonic():
    rec = trace.Recorder(capacity=16)
    for method in (None, "Search"):
        before = time.monotonic()
        with rec.span("x", method):
            time.sleep(0.001)
        after = time.monotonic()
        name, m, _, start, end = rec.spans()[-1]
        assert (name, m) == ("x", method)
        assert before <= start <= end <= after and end - start >= 0.001


def test_capacity_zero_records_no_span_but_counts():
    rec = trace.Recorder(capacity=0)
    assert rec.span("a") is rec.span("b", "Search")   # one shared null context
    with rec.span("a"):
        pass
    rec.record("b", None, 1, 2)
    rec.count("c")
    rec.count("c", 4)
    assert rec.spans() == [] and rec.oldest() is None
    assert rec.counters() == {"c": 5}
    assert rec.summary()["spans"] == [] and rec.summary()["capacity"] == 0
    rec.configure(2)
    _fill(rec, 1)
    assert len(rec.spans()) == 1
    rec.reset()
    assert rec.spans() == [] and rec.counters() == {}


def test_ring_memory_is_bounded():
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        rec = trace.Recorder()
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown <= 48 * trace.DEFAULT_CAPACITY + 4096
    _fill(rec, 3)
    assert len(rec.spans()) == 3


def test_threads_count_exactly_and_keep_every_span():
    rec = trace.Recorder(capacity=8 * 1000)
    barrier = threading.Barrier(8)

    def work(j):
        barrier.wait()
        for i in range(10_000):
            rec.count("hits")
            if i < 1000:
                rec.record("w", str(j), i, i + 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(j,)) for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert rec.counters() == {"hits": 80_000}
    held = rec.spans()
    assert len(held) == 8000
    assert sorted({s[1] for s in held}) == [str(j) for j in range(8)]
    assert all(sum(s[1] == str(j) for s in held) == 1000 for j in range(8))


# -- the served path ----------------------------------------------------------

NAME, DIM, ROWS = "docs", 32, 512
RPC_SPANS = ("rpc.queue", "rpc.call", "rpc.decode", "rpc.handler", "rpc.reply",
             "rpc.encode")


@pytest.fixture
def served(tmp_path):
    """A tiny I8 collection behind a CPU edge server; yields its client."""
    cfg = Config()
    cfg.root_layer.bind_address = "127.0.0.1:0"
    cfg.storage.object_store_root = str(tmp_path / "objects")
    cfg.serving.device = "cpu"
    cfg.serving.precompile_batches = "1"
    servicer = build_servicer("edge", cfg)
    servicer.engine.create_collection(CollectionSchema(
        name=NAME, dim=DIM, quantization=Quantization.I8,
        fields=[FieldSchema("pk", FieldType.STRING, primary_key=True)]))
    rows = np.random.default_rng(0).standard_normal((ROWS, DIM)).astype(np.float32)
    trace.reset()
    servicer.engine.index_many(NAME, [{"pk": f"p{i}"} for i in range(ROWS)], rows)
    server = create_server(servicer, cfg)
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{server.bound_port}")
    try:
        yield EdgeClient(channel), rows, cfg
    finally:
        channel.close()
        server.stop(None)


class _Keep(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.kv = []

    def emit(self, record):
        if record.getMessage() == "search_batch":
            self.kv.append(record.kv)


def test_served_calls_record_their_spans(served):
    client, rows, cfg = served
    ingest = {s[0] for s in trace.spans()}
    assert "engine.index_many" in ingest
    edge_log = logging.getLogger("coltt.edge")
    keep, level = _Keep(), edge_log.level
    edge_log.addHandler(keep)
    edge_log.setLevel(logging.DEBUG)
    groups = trace.counters().get("batcher.groups", 0)
    try:
        trace.configure()   # a fresh ring: the calls' spans alone
        before = time.monotonic()
        counts, _, ids, _ = client.search_batch(NAME, rows[:8], limit=5,
                                                high_resource=True)
        hits = client.search(NAME, rows[9], limit=5)
    finally:
        edge_log.removeHandler(keep)
        edge_log.setLevel(level)
    assert counts == [5] * 8 and ids[0] == "p0" and hits[0]["id"] == "p9"
    # a span enters the ring as it ends; a pool task's two may end after
    # the client has its reply
    deadline = time.monotonic() + 10
    while sum(s[0] == "rpc.call" for s in trace.spans()) < 2:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    after = time.monotonic()
    got = trace.spans()
    assert all(before <= s[3] <= s[4] <= after for s in got)
    by = {}
    for name, method, thread, start, end in got:
        by.setdefault((name, method), []).append((thread, start, end))
    for method in ("SearchBatch", "Search"):
        for name in RPC_SPANS:
            assert len(by.get((name, method), [])) == 1, (name, method)
        (call_t, call_s, call_e), = by[("rpc.call", method)]
        (h_t, h_s, h_e), = by[("rpc.handler", method)]
        (q_t, q_s, q_e), = by[("rpc.queue", method)]
        (_, d_s, d_e), = by[("rpc.decode", method)]
        assert h_t == call_t == q_t and call_s <= h_s <= h_e <= call_e
        assert q_e == call_s and d_e <= h_s
        (_, r_s, r_e), = by[("rpc.reply", method)]
        assert h_s <= r_s <= r_e <= h_e
    scans, flats = by[("engine.scan", None)], by[("engine.flatten", None)]
    assert len(scans) == len(flats) == 2
    # the search_batch debug record reads the first pair of engine spans
    (kv,) = keep.kv
    for key, (_, s, e) in (("scan_ms", scans[0]), ("flatten_ms", flats[0])):
        assert abs(kv[key] - (e - s) * 1e3) <= 0.005 + 1e-9
    # the one-query Search waits the batcher's whole window: no follower
    (_, h_s, h_e), = by[("rpc.handler", "Search")]
    waits = [(s, e) for _, s, e in by[("batcher.wait", None)] if h_s <= s <= h_e]
    assert len(waits) == 1
    assert waits[0][1] - waits[0][0] >= cfg.serving.scan_batch_wait_ms / 1e3
    assert len(by[("store.fetch", None)]) == 2
    assert trace.counters()["batcher.groups"] == groups + 2


def test_debug_trace_endpoint(served):
    from coltt_tpu_torch.__main__ import _start_prof_server

    client, rows, _ = served
    client.search(NAME, rows[3], limit=3)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    http = _start_prof_server(f"127.0.0.1:{port}")
    assert http is not None
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/trace",
                                    timeout=30) as r:
            assert r.headers["Content-Type"] == "application/json"
            got = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
            assert b"--- thread" in r.read()
    finally:
        http.shutdown()
        http.server_close()
    assert got["capacity"] == trace.DEFAULT_CAPACITY
    assert got["oldest"] <= time.monotonic()
    assert got["counters"]["batcher.requests"] >= 1
    rows_ = {(r["name"], r["method"]): r for r in got["spans"]}
    h = rows_[("rpc.handler", "Search")]
    assert h["count"] >= 1
    assert 0 <= h["p50_ms"] <= h["p95_ms"] <= h["max_ms"]
    assert h["mean_ms"] <= h["max_ms"]
    assert ("engine.index_many", None) in rows_

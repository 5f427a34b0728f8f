"""Core mode's served batch search on the CPU, through ``CoreServicer``
over gRPC at 8,192 x 128 rows (m=16, ef=128): the spans and counters it
records inside the HNSW search (``store/hnsw.py``), and its answers
against the plain reference (``portbench/reference.py``, an exact f32
scan of the same rows)."""

import io
import json
import socket
import time
import urllib.request

import grpc
import numpy as np
import pytest
import torch

from coltt_tpu_torch.api.client import CoreClient
from coltt_tpu_torch.api.server import build_servicer, create_server
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.store.hnsw import HnswConfig, HnswIndex
from coltt_tpu_torch.utils import trace
from coltt_tpu_torch.utils.config import Config
from portbench import data, reference

NAME, ROWS, DIM, K, Q = "sift", 8192, 128, 10, 64
CONFIG = HnswConfig(m=16, ef_construction=100, ef=128, algorithm="heuristic")
EXPAND = 16  # HnswIndex.search's default
# f32 rounding of a 128-term sum of squares near 30, with 100 - d taken in
# f32 on the way to the wire: a few 1e-6 relative
REL_TOL = 1e-4
SEARCH_SPANS = ("hnsw.descend", "hnsw.beam", "hnsw.fetch", "engine.flatten",
                "rpc.reply")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A core server on the CPU holding the mixture's rows, row ``i`` under
    the id ``str(i)``; yields its client, the servicer, the rows and 64
    queries of the same mixture."""
    cfg = Config()
    cfg.root_layer.bind_address = "127.0.0.1:0"
    cfg.storage.data_dir = str(tmp_path_factory.mktemp("core_trace") / "data")
    cfg.serving.device = "cpu"
    rows, queries = data.make_rows({"centers": 64, "sigma": 0.35, "pool": Q},
                                   ROWS, DIM, 2**31 + 3, "cpu")
    servicer = build_servicer("root", cfg)
    server = create_server(servicer, cfg)
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{server.bound_port}")
    client = CoreClient(channel)
    try:
        client.create_collection(NAME, DIM, metric=int(Metric.EUCLIDEAN),
                                 config=CONFIG)
        client.bulk_insert(NAME, rows, ext_ids=[str(i) for i in range(ROWS)])
        yield client, servicer, rows, queries
    finally:
        channel.close()
        server.stop(None)
        servicer.engine.kv.close()


def _search(client, queries):
    counts, scores, ids, _, _ = client.vector_search_batch(NAME, queries, top_k=K)
    assert counts == [K] * len(queries)
    return (np.asarray(scores, np.float64).reshape(-1, K),
            np.asarray([int(i) for i in ids]).reshape(-1, K))


def test_batch_search_records_its_spans_and_counters(served):
    from coltt_tpu_torch.__main__ import _start_prof_server

    client, _, _, queries = served
    trace.configure()   # a fresh ring: this call's spans alone
    before = trace.counters()
    counts, _, _, _, _ = client.vector_search_batch(NAME, queries, top_k=K)
    assert counts == [K] * len(queries)
    # a pool task's spans enter the ring as it ends, after the reply
    deadline = time.monotonic() + 10
    while not any(s[:2] == ("rpc.call", "VectorSearchBatch") for s in trace.spans()):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    by = {}
    for name, method, thread, start, end in trace.spans():
        by.setdefault(name, []).append((method, thread, start, end))
    (call,) = [s for s in by["rpc.call"] if s[0] == "VectorSearchBatch"]
    for name in SEARCH_SPANS:
        (span,) = by[name]
        assert span[0] == "VectorSearchBatch", name
        assert span[1] == call[1] and call[2] <= span[2] <= span[3] <= call[3], name
    descend, beam, fetch, flatten, reply = (by[n][0] for n in SEARCH_SPANS)
    assert descend[3] <= beam[2] and beam[3] <= fetch[2]
    assert fetch[3] <= flatten[2] and flatten[3] <= reply[2]

    grown = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert grown["hnsw.queries"] == Q and grown["hnsw.blocks"] == 1
    assert 1 <= grown["hnsw.beam_iters"] <= max(2 * CONFIG.ef // EXPAND, 8)
    assert grown["hnsw.descend_hops"] >= 1
    # at least one row read and its neighbours scored per query and level
    assert grown["hnsw.expanded"] >= Q and grown["hnsw.scored"] >= Q
    # the ids the flatten gathered from the id column: every served hit
    assert grown["engine.flatten_rows"] == sum(counts)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    http = _start_prof_server(f"127.0.0.1:{port}")
    assert http is not None
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/trace",
                                    timeout=30) as r:
            got = json.loads(r.read())
    finally:
        http.shutdown()
        http.server_close()
    for name in ("queries", "descend_hops", "beam_iters", "scored", "expanded",
                 "blocks"):
        assert got["counters"][f"hnsw.{name}"] >= grown[f"hnsw.{name}"], name
    assert got["counters"]["engine.flatten_rows"] >= grown["engine.flatten_rows"]
    listed = {(r["name"], r["method"]) for r in got["spans"]}
    assert {(n, "VectorSearchBatch") for n in SEARCH_SPANS} <= listed


def _distances(scores):
    """Served 0-100 euclidean scores back to squared L2 distances, where
    the score is above its clamp at 0."""
    return np.where(scores > 0, 100.0 - scores, np.nan)


def _pair_d64(queries, rows, ids):
    q = queries.astype(np.float64)[:, None, :]
    return ((q - rows.astype(np.float64)[ids]) ** 2).sum(axis=2)


def test_batch_search_against_the_plain_reference(served):
    client, servicer, rows, queries = served
    scores, ids = _search(client, queries)
    assert ((ids >= 0) & (ids < ROWS)).all()
    assert all(len(set(r)) == K for r in ids.tolist())

    served_d = _distances(scores)
    exact_d = _pair_d64(queries, rows, ids)
    kept = np.isfinite(served_d)
    assert kept.mean() > 0.9
    rel = np.abs(served_d[kept] - exact_d[kept]) / exact_d[kept]
    assert rel.max() <= REL_TOL, rel.max()

    _, ref_ids = reference.exact_topk(queries, rows, K, "euclidean", "cpu")
    recall = np.mean([len(set(a) & set(b)) / K
                      for a, b in zip(ids.tolist(), ref_ids.tolist())])
    assert recall >= 0.95, recall

    # the same graph searched in bf16 misses the tolerance by over 10x
    buf = io.BytesIO()
    servicer.engine._collections[NAME].hnsw.save(buf)
    buf.seek(0)
    bf16 = HnswIndex.load(buf, device="cpu", device_dtype=torch.bfloat16)
    d_bf16, slots = bf16.search(queries, K)
    exact_bf16 = _pair_d64(queries, rows, slots)
    assert (np.abs(d_bf16 - exact_bf16) / exact_bf16).max() > 10 * REL_TOL

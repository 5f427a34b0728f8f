"""The port's edge slice as a whole vs the JAX engine, at 8192 x 128.

Both engines serve one int8 cosine collection built from the same numpy
data: create -> index_many -> search_batch (plain and high_resource) ->
filtered search -> flush / release / load. They must return the same
primary keys, with scores within the tolerance of
``tests/test_torch_flat_store.py`` (1e-3 on the 0-100 scale, near-ties
allowed to trade places). Each engine loads the three checkpoint objects
the other flushed. A gRPC round trip runs through the port's server and
``EdgeClient``. Queries are f16 values (see test_torch_flat_store.py).
"""

import grpc
import numpy as np
import pytest
import torch
from test_torch_flat_store import assert_same_search

from coltt_tpu.engine.edge import EdgeEngine as JEdgeEngine
from coltt_tpu.index.schema import CollectionSchema as JSchema
from coltt_tpu.storage.objectstore import LocalObjectStore as JObjectStore
from coltt_tpu_torch.api.client import EdgeClient
from coltt_tpu_torch.api.server import build_servicer, create_server
from coltt_tpu_torch.engine.edge import EdgeEngine
from coltt_tpu_torch.index.filter import Filter, Op, Or
from coltt_tpu_torch.index.schema import CollectionSchema, FieldSchema, FieldType
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.storage.objectstore import LocalObjectStore
from coltt_tpu_torch.utils import trace
from coltt_tpu_torch.utils.config import Config

torch.set_num_threads(2)

N, DIM, K, TAGS = 6000, 128, 10, 8
NAME = "docs"


def _schema():
    return CollectionSchema(
        name=NAME, dim=DIM, quantization=Quantization.I8,
        fields=[FieldSchema("pk", FieldType.STRING, primary_key=True),
                FieldSchema("tag", FieldType.STRING)],
    )


def _data(seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((N, DIM)).astype(np.float32)
    mds = [{"pk": f"d{i}", "tag": f"t{i % TAGS}"} for i in range(N)]
    queries = rng.standard_normal((16, DIM)).astype(np.float16).astype(np.float32)
    return vecs, mds, queries


def _rows(counts, scores, pks):
    """Columnar SearchBatch results -> per-query (scores, pk) arrays."""
    s = np.full((len(counts), K), -np.inf, np.float32)
    p = np.full((len(counts), K), "", object)
    row = 0
    for q, c in enumerate(counts):
        s[q, :c] = scores[row:row + c]
        p[q, :c] = pks[row:row + c]
        row += c
    return s, p


def _same(jres, tres):
    """search_batch results of both engines: same pks up to near-ties."""
    js, jp = _rows(*jres[:3])
    ts, tp = _rows(*tres[:3])
    ids = {pk: i for i, pk in enumerate(set(jp.ravel()) | set(tp.ravel()))}
    to_ids = np.vectorize(lambda pk: ids[pk] if pk else -1)
    assert_same_search((js, to_ids(jp)), (ts, to_ids(tp)))


def _engines(tmp_path):
    j = JEdgeEngine(JObjectStore(str(tmp_path / "jax")), precompile_batches=())
    t = EdgeEngine(LocalObjectStore(str(tmp_path / "port")), device="cpu",
                   warmup_batches=(1, 4))
    return j, t


def test_edge_slice_matches_jax_engine(tmp_path):
    vecs, mds, queries = _data()
    j, t = _engines(tmp_path)
    j.create_collection(JSchema.from_dict(_schema().to_dict()))
    t.create_collection(_schema())
    for e in (j, t):
        for lo in range(0, N, 2000):
            e.index_many(NAME, [dict(m) for m in mds[lo:lo + 2000]],
                         vecs[lo:lo + 2000])
    assert j.get_collection(NAME)["size"] == t.get_collection(NAME)["size"] == N
    assert (j.get_collection(NAME)["memory_bytes"]
            == t.get_collection(NAME)["memory_bytes"])

    for hr in (False, True):
        _same(j.search_batch(NAME, queries, limit=K, high_resource=hr),
              t.search_batch(NAME, queries, limit=K, high_resource=hr))
    # a stored row finds itself first, through both scans
    for hr in (False, True):
        hits = t.search(NAME, vecs[42], limit=3, high_resource=hr)
        assert hits[0].id == "d42" and hits[0].metadata["tag"] == "t2"

    # filtered: one tag gathers 750 rows; an OR of four takes the masked scan
    one = Filter("tag", Op.EQ, "t3")
    four = Or(*[Filter("tag", Op.EQ, f"t{i}") for i in range(4)])
    for expr in (one, four):
        jres = j.search_batch(NAME, queries, limit=K, filter_expression=expr.to_dict())
        tres = t.search_batch(NAME, queries, limit=K, filter_expression=expr)
        _same(jres, tres)
    hits = t.search(NAME, queries[0], limit=K, filter_expression=one)
    assert len(hits) == K and all(h.metadata["tag"] == "t3" for h in hits)

    # deletes land in both, then each engine reloads its own checkpoint
    for e in (j, t):
        for i in range(0, 300, 3):
            e.index(NAME, {"pk": f"d{i}"}, delete=True)
        e.flush(NAME)
        e.release_collection(NAME)
        e.load_collection(NAME)
    for hr in (False, True):
        jres = j.search_batch(NAME, queries, limit=K, high_resource=hr)
        tres = t.search_batch(NAME, queries, limit=K, high_resource=hr)
        _same(jres, tres)
        assert not {f"d{i}" for i in range(0, 300, 3)} & set(tres[2])


def test_checkpoints_load_across_packages(tmp_path):
    """The three checkpoint objects each engine flushes load in the other."""
    vecs, mds, queries = _data(seed=1)
    j, t = _engines(tmp_path)
    j.create_collection(JSchema.from_dict(_schema().to_dict()))
    t.create_collection(_schema())
    for e in (j, t):
        e.index_many(NAME, [dict(m) for m in mds], vecs)
        e.release_collection(NAME)  # flushes

    t_reads_jax = EdgeEngine(LocalObjectStore(str(tmp_path / "jax")), device="cpu",
                             warmup_batches=())
    j_reads_port = JEdgeEngine(JObjectStore(str(tmp_path / "port")),
                               precompile_batches=())
    for e in (j, t, t_reads_jax, j_reads_port):
        e.load_collection(NAME)
        assert e.get_collection(NAME)["size"] == N
    want = j.search_batch(NAME, queries, limit=K, with_metadata=True)
    for e in (t, t_reads_jax, j_reads_port):
        got = e.search_batch(NAME, queries, limit=K, with_metadata=True)
        _same(want, got)
        assert all(m["tag"] == f"t{int(pk[1:]) % TAGS}"
                   for m, pk in zip(got[3], got[2]))
    expr = Filter("tag", Op.EQ, "t5")
    _same(j.search_batch(NAME, queries, limit=K, filter_expression=expr.to_dict()),
          t_reads_jax.search_batch(NAME, queries, limit=K, filter_expression=expr))


@pytest.fixture
def edge_client(tmp_path):
    cfg = Config()
    cfg.root_layer.bind_address = "127.0.0.1:0"
    cfg.storage.object_store_root = str(tmp_path / "objects")
    cfg.serving.device = "cpu"
    cfg.serving.precompile_batches = "1"
    cfg.root_layer.max_recv_msg_size = 64 << 20
    server = create_server(build_servicer("edge", cfg), cfg)
    server.start()
    channel = grpc.insecure_channel(
        f"127.0.0.1:{server.bound_port}",
        options=[("grpc.max_send_message_length", 64 << 20)])
    try:
        yield EdgeClient(channel)
    finally:
        channel.close()
        server.stop(None)


def test_grpc_round_trip(edge_client):
    vecs, mds, queries = _data(seed=2)
    c = edge_client
    assert c.ping()
    c.create_collection(_schema())
    c.bulk_index(NAME, [m["pk"] for m in mds[:4000]], vecs[:4000],
                 [{"tag": m["tag"]} for m in mds[:4000]])
    c.bulk_index(NAME, [m["pk"] for m in mds[4000:]], vecs[4000:],
                 [{"tag": m["tag"]} for m in mds[4000:]])
    assert c.get_collection(NAME).collection_size == N
    for hr in (False, True):
        counts, scores, ids, _ = c.search_batch(NAME, vecs[:8], limit=K,
                                                high_resource=hr)
        assert counts == [K] * 8
        assert [ids[q * K] for q in range(8)] == [f"d{q}" for q in range(8)]
    hits = c.search(NAME, vecs[9], limit=5, high_resource=True,
                    filter_expression=Filter("tag", Op.EQ, "t1"))
    assert hits[0]["id"] == "d9" and all(h["metadata"]["tag"] == "t1" for h in hits)
    c.index(NAME, "d0", delete=True)
    c.flush(NAME)
    c.release_collection(NAME)
    assert not c.get_collection(NAME).load
    c.load_collection(NAME)
    _, _, ids, _ = c.search_batch(NAME, vecs[:8], limit=K, high_resource=True)
    assert "d0" not in ids and ids[K] == "d1"
    # PQ and BQ collections are served too (the flows below)
    for q in (Quantization.PQ, Quantization.BQ):
        c.create_collection(CollectionSchema(
            name=q.name.lower(), dim=DIM, quantization=q,
            fields=[FieldSchema("pk", FieldType.STRING, primary_key=True)]))
        assert c.get_collection(q.name.lower()).load


def _schema_of(name, dim, quant, field):
    return CollectionSchema(
        name=name, dim=dim, quantization=quant,
        fields=[FieldSchema("pk", FieldType.STRING, primary_key=True),
                FieldSchema(field, FieldType.STRING)])


def _cross_load(tmp_path, name, check):
    """Each package's engine loads the checkpoint the other flushed; the
    loaded collection answers as its writer does (``check(writer,
    reader)``)."""
    j_reads_port = JEdgeEngine(JObjectStore(str(tmp_path / "port")), precompile_batches=())
    t_reads_jax = EdgeEngine(LocalObjectStore(str(tmp_path / "jax")), device="cpu",
                             warmup_batches=())
    writers = _engines(tmp_path)
    for writer, reader in ((writers[1], j_reads_port), (writers[0], t_reads_jax)):
        writer.load_collection(name)
        reader.load_collection(name)
        check(writer, reader)


def test_bq_collection_flow_both_engines(tmp_path, edge_client):
    """tests/test_api.py's BQ flow: one-by-one Index, a self-match first
    (exact bits + rerank), a filtered Search, the checkpoint round trip;
    through the port's gRPC server and on the JAX engine, each engine then
    loading the other's checkpoint."""
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((32, 64)).astype(np.float32)
    name = "bqdocs"
    schema = _schema_of(name, 64, Quantization.BQ, "lang")
    c = edge_client
    c.create_collection(schema)
    assert c.get_collection(name).load
    for i in range(32):
        c.index(name, f"p{i}", vecs[i], {"lang": ["ko", "en"][i % 2]})
    hits = c.search(name, vecs[7], limit=3)
    assert hits[0]["id"] == "p7" and 0.0 <= hits[0]["score"] <= 100.1
    expr = Filter("lang", Op.EQ, "ko")
    hits = c.search(name, vecs[4], limit=8, filter_expression=expr)
    assert hits and all(h["metadata"]["lang"] == "ko" for h in hits)
    assert hits[0]["id"] == "p4"
    c.flush(name)
    c.release_collection(name)
    c.load_collection(name)
    assert c.search(name, vecs[9], limit=1)[0]["id"] == "p9"
    c.delete_collection(name)

    # the same flow on both engines, then each reads the other's objects
    j, t = _engines(tmp_path)
    j.create_collection(JSchema.from_dict(schema.to_dict()))
    t.create_collection(schema)
    for e in (j, t):
        for i in range(32):
            e.index(name, {"pk": f"p{i}", "lang": ["ko", "en"][i % 2]}, vecs[i])
        assert e.search(name, vecs[7], limit=3)[0].id == "p7"
        e.release_collection(name)

    def check(writer, reader):
        for v in (vecs[:8], vecs[20:24]):
            _same(writer.search_batch(name, v, limit=K),
                  reader.search_batch(name, v, limit=K))
        hits = reader.search(name, vecs[4], limit=8, filter_expression=expr.to_dict()
                             if isinstance(reader, JEdgeEngine) else expr)
        assert hits[0].id == "p4" and all(h.metadata["lang"] == "ko" for h in hits)

    _cross_load(tmp_path, name, check)


def test_pq_collection_flow_both_engines(tmp_path):
    """tests/test_edge_engine.py's PQ flow on both engines (each trains its
    own codebook, with OPQ, on the first sync), then each engine loads the
    other's checkpoint and answers exactly as the writer does."""
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((8, 32)).astype(np.float32)
    vecs = (centers[rng.integers(0, 8, 300)]
            + 0.05 * rng.standard_normal((300, 32))).astype(np.float32)
    mds = [{"pk": f"p{i}", "city": ["a", "b"][i % 2]} for i in range(300)]
    name = "pqcol"
    schema = _schema_of(name, 32, Quantization.PQ, "city")
    j, t = _engines(tmp_path)
    j.create_collection(JSchema.from_dict(schema.to_dict()))
    t.create_collection(schema)
    b = Filter("city", Op.EQ, "b")
    for e in (j, t):
        e.index_many(name, [dict(m) for m in mds], vecs)
        for hr in (False, True):
            assert "p11" in [h.id for h in e.search(name, vecs[11], limit=20,
                                                    high_resource=hr)]
        hits = e.search(name, vecs[11], limit=20, filter_expression=b.to_dict()
                        if e is j else b)
        assert hits and all(h.metadata["city"] == "b" for h in hits)
        e.flush(name)
        e.release_collection(name)
        e.load_collection(name)
        assert "p11" in [h.id for h in e.search(name, vecs[11], limit=20)]
        e.release_collection(name)
    assert t._collections == {} and t.get_collection(name)["size"] == 0

    def check(writer, reader):
        for hr in (False, True):
            _same(writer.search_batch(name, vecs[:16], limit=K, high_resource=hr),
                  reader.search_batch(name, vecs[:16], limit=K, high_resource=hr))
        assert reader.get_collection(name)["size"] == 300

    _cross_load(tmp_path, name, check)


def test_unported_modes_raise(tmp_path):
    """Every mode serves (core: tests/test_torch_core_api.py; experimental:
    tests/test_torch_experimental.py), and so do what was last to port:
    the S3 object store and several devices, which build and serve on the
    CPU. An unknown mode raises, as do more CUDA shards than cards."""
    from fake_s3 import start_fake_s3

    cfg = Config()
    cfg.storage.data_dir = str(tmp_path / "data")
    cfg.storage.object_store_root = str(tmp_path / "objects")
    cfg.serving.device = "cpu"
    servicer = build_servicer("root", cfg)
    servicer.engine.close()
    srv, addr = start_fake_s3()
    try:
        cfg.storage.object_store = "s3"
        cfg.storage.s3_endpoint = addr
        cfg.serving.shards = 2
        for mode in ("edge", "experimental"):
            engine = build_servicer(mode, cfg).engine
            assert type(engine.objects).__name__ == "S3ObjectStore"
            assert engine.mesh.shape["shard"] == 2
        rows = np.random.default_rng(5).standard_normal((40, 16)).astype(np.float32)
        engine = build_servicer("edge", cfg).engine
        engine.create_collection(_schema_of("s3col", 16, Quantization.F16, "tag"))
        engine.index_many("s3col", [{"pk": f"p{i}", "tag": "a"} for i in range(40)], rows)
        assert engine.search("s3col", rows[7], limit=1)[0].id == "p7"
        engine.flush("s3col")
        again = build_servicer("edge", cfg).engine
        again.load_collection("s3col")
        assert again.search("s3col", rows[9], limit=1)[0].id == "p9"
    finally:
        srv.shutdown()
    cfg.storage.object_store = "local"
    with pytest.raises(ValueError, match="unknown mode"):
        build_servicer("nope", cfg)
    cfg.serving.device = "cuda"
    cfg.serving.shards = torch.cuda.device_count() + 2
    with pytest.raises(ValueError, match="exceeds available CUDA devices"):
        build_servicer("edge", cfg)


def test_main_serves_edge_mode(tmp_path):
    """``python -m coltt_tpu_torch`` serves the edge mode from a config
    file and stops cleanly on SIGTERM."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    (tmp_path / "coltt.toml").write_text(
        'mode = "edge"\n'
        "[root_layer]\n"
        f'bind_address = "127.0.0.1:{port}"\n'
        'prof_address = "127.0.0.1:0"\n'
        "[storage]\n"
        f'data_dir = "{tmp_path / "data"}"\n'
        f'object_store_root = "{tmp_path / "objects"}"\n'
        "[serving]\n"
        'device = "cpu"\n')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [repo, os.environ.get("PYTHONPATH")])))
    proc = subprocess.Popen(
        [sys.executable, "-m", "coltt_tpu_torch", "--config", "coltt.toml"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        grpc.channel_ready_future(channel).result(timeout=60)
        client = EdgeClient(channel)
        assert client.ping()
        client.create_collection(_schema())
        assert client.get_collection(NAME).load
        channel.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out.decode()
    assert b"server started" in out and b"bye" in out
    assert (tmp_path / "objects" / NAME / f"{NAME}.meta.json").exists()


# -- the flatten against the dict lookup it replaced ---------------------------

FLAT_N = 600


@pytest.fixture(scope="module")
def flatten_engine(tmp_path_factory):
    """A port collection of FLAT_N rows (three tagged "rare"), with d5
    deleted and its slot taken by a fresh row."""
    vecs, mds, _ = _data(seed=3)
    vecs, mds = vecs[:FLAT_N], mds[:FLAT_N]
    for i in (11, 222, 433):
        mds[i]["tag"] = "rare"
    e = EdgeEngine(LocalObjectStore(str(tmp_path_factory.mktemp("flatten"))),
                   device="cpu", warmup_batches=())
    e.create_collection(_schema())
    e.index_many(NAME, [dict(m) for m in mds], vecs)
    freed = e._collections[NAME].store.pk_to_slot["d5"]
    e.index(NAME, {"pk": "d5"}, delete=True)
    e.index(NAME, {"pk": "fresh", "tag": "t0"}, vecs[5] + 0.01)
    assert e._collections[NAME].store.pk_to_slot["fresh"] == freed
    queries = np.concatenate([vecs[[5, 11, 42]], _data(seed=4)[2][:5]])
    return e, queries


def _dict_flatten(engine, queries, *, limit, offset=0, filter_expression=None,
                  high_resource=False, with_metadata=False):
    """search_batch's answer by the flatten the key column replaced: one
    slot_to_pk and metadata dict lookup a hit, on the same scan."""
    col = engine._collections[NAME]
    cand = engine._candidates(col, filter_expression)
    scores, slots = engine._scan(NAME, col, queries, limit + offset, cand,
                                 high_resource)
    counts, out_s, out_p, out_m = [], [], [], []
    for s_row, i_row in zip(scores[:, offset:], slots[:, offset:]):
        live = [(s, i) for s, i in zip(s_row, i_row) if i >= 0 and np.isfinite(s)]
        counts.append(len(live))
        for s, i in live:
            out_s.append(float(s))
            out_p.append(col.store.slot_to_pk.get(int(i), ""))
            out_m.append(col.metadata.get(int(i), {}))
    return counts, out_s, out_p, out_m if with_metadata else None


FLATTEN_CASES = {
    "plain": dict(limit=10),
    "offset": dict(limit=5, offset=3),
    "metadata": dict(limit=10, with_metadata=True, high_resource=True),
    "fewer_than_k": dict(limit=10, filter_expression=Filter("tag", Op.EQ, "rare")),
}


@pytest.mark.parametrize("case", list(FLATTEN_CASES))
def test_flatten_matches_the_dict_lookup(flatten_engine, case):
    engine, queries = flatten_engine
    opts = dict(FLATTEN_CASES[case])
    want = _dict_flatten(engine, queries, **opts)
    before = trace.counters().get("engine.flatten_rows", 0)
    got = engine.search_batch(NAME, queries, **opts)
    assert trace.counters()["engine.flatten_rows"] - before == len(got[2])
    assert got == want
    assert len(got[2]) == sum(got[0]) and "d5" not in got[2]
    if case == "fewer_than_k":
        assert got[0] == [3] * len(queries)
    if case == "plain":
        assert got[2][0] == "fresh"  # d5's old slot, its new key
    opts.pop("with_metadata", None)
    for q in queries[:4]:
        counts, scores, pks, mds = _dict_flatten(engine, q[None], with_metadata=True, **opts)
        hits = engine.search(NAME, q, **opts)
        assert [(h.id, h.score, h.metadata) for h in hits] == list(zip(pks, scores, mds))

"""The port's experimental (CFLAT) engine and server vs the JAX package.

The reference's ``tests/test_experimental_engine.py`` cases run against
the port's engine; both engines take the same records (numpy rows from a
seed) and must return the same ids, with scores within 1e-3 on the 0-100
scale (near-ties may trade places, as in ``tests/test_torch_multivec.py``);
each loads the checkpoint the other flushed. ``tests/test_api.py``'s two
experimental flows run through the port's server and
``ExperimentalClient``, and ``python -m coltt_tpu_torch --mode
experimental`` serves.
"""

import grpc
import numpy as np
import pytest
import torch
from test_torch_edge import _rows
from test_torch_flat_store import assert_same_search

from coltt_tpu.engine.experimental import ExperimentalEngine as JEngine
from coltt_tpu.index.schema import CollectionSchema as JSchema
from coltt_tpu.storage.objectstore import LocalObjectStore as JObjectStore
from coltt_tpu_torch.api.client import ExperimentalClient
from coltt_tpu_torch.api.server import build_servicer, create_server
from coltt_tpu_torch.engine.errors import EngineError
from coltt_tpu_torch.engine.experimental import ExperimentalEngine
from coltt_tpu_torch.index.schema import CollectionSchema, FieldSchema, FieldType
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.storage.objectstore import LocalObjectStore
from coltt_tpu_torch.utils.config import Config

torch.set_num_threads(2)

DIM = 12
K = 10


def _schema(name="mv1", quant=Quantization.NONE):
    return CollectionSchema(
        name=name,
        dim=DIM,
        quantization=quant,
        fields=[
            FieldSchema("title_vec", FieldType.VECTOR),
            FieldSchema("body_vec", FieldType.VECTOR),
            FieldSchema("lang", FieldType.STRING, enable_null=True),
        ],
    )


@pytest.fixture
def engine(tmp_path):
    return ExperimentalEngine(LocalObjectStore(str(tmp_path / "os")), device="cpu")


def _fill(engine, rng, n=25, name="mv1"):
    t = rng.standard_normal((n, DIM), dtype=np.float32)
    b = rng.standard_normal((n, DIM), dtype=np.float32)
    for i in range(n):
        engine.index(
            name, f"r{i}",
            vectors={"title_vec": t[i], "body_vec": b[i]},
            metadata={"lang": ["ko", "en"][i % 2]},
        )
    return t, b


# -- the reference's engine cases, on the port ---------------------------------

def test_create_requires_vector_field(engine):
    bad = CollectionSchema(
        name="x", dim=DIM, fields=[FieldSchema("lang", FieldType.STRING)])
    with pytest.raises(EngineError):
        engine.create_collection(bad)


def test_multi_vector_search(engine, rng):
    engine.create_collection(_schema())
    t, b = _fill(engine, rng)
    hits = engine.vector_search(
        "mv1", [("title_vec", t[7], True, 50.0), ("body_vec", b[7], True, 50.0)],
        top_k=3)
    assert hits[0].id == "r7"
    assert hits[0].score > 99.0
    assert hits[0].metadata["lang"] == "en"


def test_include_flag_excludes_field(engine, rng):
    engine.create_collection(_schema())
    t, b = _fill(engine, rng)
    hits = engine.vector_search(
        "mv1", [("title_vec", t[4], True, 100.0), ("body_vec", b[9], False, 0.0)],
        top_k=1)
    assert hits[0].id == "r4"
    with pytest.raises(EngineError):
        engine.vector_search("mv1", [("title_vec", t[0], False, 100.0)], top_k=1)


def test_delete_record(engine, rng):
    engine.create_collection(_schema())
    t, b = _fill(engine, rng, n=10)
    engine.index("mv1", "r5", delete=True)
    assert engine.get_collection("mv1")["size"] == 9
    hits = engine.vector_search("mv1", [("title_vec", t[5], True, 100.0)], top_k=9)
    assert "r5" not in [h.id for h in hits]


def test_flush_reload_roundtrip(tmp_path, rng):
    store = LocalObjectStore(str(tmp_path / "os"))
    e1 = ExperimentalEngine(store, device="cpu")
    e1.create_collection(_schema())
    t, b = _fill(e1, rng, n=15)
    e1.close()
    e2 = ExperimentalEngine(store, device="cpu")
    e2.load_collection("mv1")
    hits = e2.vector_search(
        "mv1", [("title_vec", t[11], True, 60.0), ("body_vec", b[11], True, 40.0)],
        top_k=1)
    assert hits[0].id == "r11"
    assert hits[0].metadata["lang"] == "en"


def test_missing_field_rejected(engine, rng):
    engine.create_collection(_schema())
    with pytest.raises(EngineError):
        engine.index("mv1", "bad", vectors={"title_vec": np.zeros(DIM, np.float32)},
                     metadata={})
    with pytest.raises(EngineError):
        engine.index("mv1", "", vectors=None, metadata={})


def test_index_many_is_atomic(engine, rng):
    """A bad id or metadata row anywhere in a bulk upsert applies nothing."""
    engine.create_collection(_schema())
    t = rng.standard_normal((4, DIM), dtype=np.float32)
    blocks = {"title_vec": t, "body_vec": t}
    with pytest.raises(EngineError, match="record id"):
        engine.index_many("mv1", ["a", "b", "", "d"], blocks)
    with pytest.raises(EngineError):
        engine.index_many("mv1", ["a", "b", "c", "d"], blocks,
                          [{}, {}, {"lang": 7}, {}])
    with pytest.raises(EngineError, match="block rows"):
        engine.index_many("mv1", ["a", "b", "c"], blocks)
    assert engine.get_collection("mv1")["size"] == 0
    assert engine.index_many("mv1", ["a", "b", "c", "d"], blocks) == 4
    assert engine.get_collection("mv1")["size"] == 4


# -- both engines on the same records ------------------------------------------

def _data(seed=0, n=300, nq=8):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, DIM)).astype(np.float32)
    b = rng.standard_normal((n, DIM)).astype(np.float32)
    mds = [{"lang": ["ko", "en", "ja"][i % 3]} for i in range(n)]
    qt = rng.standard_normal((nq, DIM)).astype(np.float32)
    qb = rng.standard_normal((nq, DIM)).astype(np.float32)
    return t, b, mds, qt, qb


def _same(jres, tres):
    """vector_search_batch results of both engines: same ids up to
    near-ties, scores within 1e-3."""
    js, jp = _rows(*jres[:3])
    ts, tp = _rows(*tres[:3])
    ids = {pk: i for i, pk in enumerate(set(jp.ravel()) | set(tp.ravel()))}
    to_ids = np.vectorize(lambda pk: ids[pk] if pk else -1)
    assert_same_search((js, to_ids(jp)), (ts, to_ids(tp)))


def _fill_both(j, t, quant, data):
    tv, bv, mds, _, _ = data
    j.create_collection(JSchema.from_dict(_schema("mv", quant).to_dict()))
    t.create_collection(_schema("mv", quant))
    ids = [f"r{i}" for i in range(len(mds))]
    for e in (j, t):
        e.index_many("mv", ids[:200], {"title_vec": tv[:200], "body_vec": bv[:200]},
                     [dict(m) for m in mds[:200]])
        for i in range(200, len(ids)):
            e.index("mv", ids[i], vectors={"title_vec": tv[i], "body_vec": bv[i]},
                    metadata=dict(mds[i]))
        for i in range(0, len(ids), 11):
            e.index("mv", ids[i], delete=True)


@pytest.mark.parametrize("quant", [Quantization.NONE, Quantization.F8],
                         ids=lambda q: q.name)
def test_engine_matches_jax_engine(tmp_path, quant):
    data = _data()
    _, _, _, qt, qb = data
    j = JEngine(JObjectStore(str(tmp_path / "jax")))
    t = ExperimentalEngine(LocalObjectStore(str(tmp_path / "port")), device="cpu")
    _fill_both(j, t, quant, data)
    assert j.get_collection("mv")["size"] == t.get_collection("mv")["size"]
    assert j.get_collection("mv")["memory_bytes"] == t.get_collection("mv")["memory_bytes"]
    for query in ([("title_vec", qt, True, 70.0), ("body_vec", qb, True, 30.0)],
                  [("title_vec", qt, False, 70.0), ("body_vec", qb, True, 100.0)]):
        jres = j.vector_search_batch("mv", query, top_k=K, with_metadata=True)
        tres = t.vector_search_batch("mv", query, top_k=K, with_metadata=True)
        _same(jres, tres)
        assert all(m["lang"] == ["ko", "en", "ja"][int(pk[1:]) % 3]
                   for m, pk in zip(tres[3], tres[2]))
    single = t.vector_search("mv", [("title_vec", qt[2], True, 70.0),
                                    ("body_vec", qb[2], True, 30.0)], top_k=K)
    jsingle = j.vector_search("mv", [("title_vec", qt[2], True, 70.0),
                                     ("body_vec", qb[2], True, 30.0)], top_k=K)
    assert [h.id for h in single] == [h.id for h in jsingle]


def test_checkpoints_load_across_packages(tmp_path):
    """The checkpoint each engine flushes loads in the other and answers
    with the same ids."""
    data = _data(seed=1)
    _, _, _, qt, qb = data
    j = JEngine(JObjectStore(str(tmp_path / "jax")))
    t = ExperimentalEngine(LocalObjectStore(str(tmp_path / "port")), device="cpu")
    _fill_both(j, t, Quantization.F8, data)
    query = [("title_vec", qt, True, 60.0), ("body_vec", qb, True, 40.0)]
    want = j.vector_search_batch("mv", query, top_k=K)
    for e in (j, t):
        e.release_collection("mv")  # flushes
    t_reads_jax = ExperimentalEngine(LocalObjectStore(str(tmp_path / "jax")),
                                     device="cpu")
    j_reads_port = JEngine(JObjectStore(str(tmp_path / "port")))
    for e in (t_reads_jax, j_reads_port, t):
        e.load_collection("mv")
        got = e.vector_search_batch("mv", query, top_k=K, with_metadata=True)
        _same(want, got)
        assert all(m["lang"] == ["ko", "en", "ja"][int(pk[1:]) % 3]
                   for m, pk in zip(got[3], got[2]))
    assert (t_reads_jax.get_collection("mv")["size"]
            == j_reads_port.get_collection("mv")["size"] == 272)


# -- gRPC ------------------------------------------------------------------------

@pytest.fixture
def exp(tmp_path):
    cfg = Config()
    cfg.root_layer.bind_address = "127.0.0.1:0"
    cfg.storage.data_dir = str(tmp_path / "data")
    cfg.storage.object_store_root = str(tmp_path / "objects")
    cfg.serving.device = "cpu"
    server = create_server(build_servicer("experimental", cfg), cfg)
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{server.bound_port}")
    try:
        yield ExperimentalClient(channel)
    finally:
        channel.close()
        server.stop(None)


def _api_schema(name):
    return CollectionSchema(
        name=name, dim=8,
        fields=[
            FieldSchema("a_vec", FieldType.VECTOR),
            FieldSchema("b_vec", FieldType.VECTOR),
            FieldSchema("lang", FieldType.STRING, enable_null=True),
        ],
    )


def test_experimental_full_flow(exp, rng):
    assert exp.ping()
    exp.create_collection(_api_schema("mv"))
    a = rng.standard_normal((12, 8), dtype=np.float32)
    b = rng.standard_normal((12, 8), dtype=np.float32)
    for i in range(12):
        exp.index("mv", f"r{i}", vectors={"a_vec": a[i], "b_vec": b[i]},
                  metadata={"lang": "ko"})
    hits = exp.vector_search("mv", [("a_vec", a[5], True, 50), ("b_vec", b[5], True, 50)],
                             top_k=2)
    assert hits[0]["id"] == "r5"
    assert hits[0]["score"] > 99.0
    # include_or_not=False drops the field
    hits = exp.vector_search("mv", [("a_vec", a[9], True, 100), ("b_vec", b[2], False, 0)],
                             top_k=1)
    assert hits[0]["id"] == "r9"
    exp.index("mv", "r3", delete=True)
    assert exp.get_collection("mv").collection_size == 11
    exp.flush("mv")
    exp.release_collection("mv")
    assert not exp.get_collection("mv").load
    exp.load_collection("mv")
    hits = exp.vector_search("mv", [("a_vec", a[3], True, 100)], top_k=11)
    assert "r3" not in [h["id"] for h in hits] and len(hits) == 11
    exp.delete_collection("mv")


def test_experimental_search_batch_rpc(exp, rng):
    """VectorSearchBatch through real gRPC agrees with Q single
    VectorSearch calls (same ranking key), columnar response contract."""
    exp.create_collection(_api_schema("mvb"))
    a = rng.standard_normal((30, 8), dtype=np.float32)
    b = rng.standard_normal((30, 8), dtype=np.float32)
    exp.bulk_index("mvb", [f"r{i}" for i in range(30)], {"a_vec": a, "b_vec": b},
                   [{"lang": ["ko", "en"][i % 2]} for i in range(30)])
    nq = 6
    counts, scores, ids, mds = exp.vector_search_batch(
        "mvb", [("a_vec", a[:nq], True, 60), ("b_vec", b[:nq], True, 40)],
        top_k=3, include_metadata=True)
    assert len(counts) == nq and sum(counts) == len(ids) == len(scores)
    assert mds is not None and len(mds) == len(ids)
    off = 0
    for q in range(nq):
        single = exp.vector_search(
            "mvb", [("a_vec", a[q], True, 60), ("b_vec", b[q], True, 40)], top_k=3)
        got = ids[off:off + counts[q]]
        assert got == [h["id"] for h in single]
        assert got[0] == f"r{q}"  # self-match wins at 60/40 weights
        np.testing.assert_allclose(scores[off:off + counts[q]],
                                   [h["score"] for h in single], rtol=1e-5)
        assert mds[off]["lang"] == ["ko", "en"][q % 2]
        off += counts[q]
    # an excluded block is dropped server-side
    counts2, _, ids2, _ = exp.vector_search_batch(
        "mvb", [("a_vec", a[:2], True, 100), ("b_vec", b[3:5], False, 0)], top_k=1)
    assert ids2[:1] == ["r0"] and counts2 == [1, 1]
    # the bulk handlers check each block against the schema dim
    with pytest.raises(RuntimeError, match="count 2 \\* dim 8"):
        exp.vector_search_batch("mvb", [("a_vec", a[:2, :4], True, 100)], top_k=1)
    with pytest.raises(RuntimeError, match="dim 8"):
        exp.bulk_index("mvb", ["x"], {"a_vec": a[:1, :4], "b_vec": b[:1]})
    exp.delete_collection("mvb")


def test_main_serves_experimental_mode(tmp_path):
    """``python -m coltt_tpu_torch --mode experimental`` serves the
    experimental service and stops cleanly on SIGTERM."""
    import os
    import signal
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    (tmp_path / "coltt.toml").write_text(
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
        [sys.executable, "-m", "coltt_tpu_torch", "--mode", "experimental",
         "--config", "coltt.toml"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        grpc.channel_ready_future(channel).result(timeout=60)
        client = ExperimentalClient(channel)
        assert client.ping()
        client.create_collection(_api_schema("mvm"))
        assert client.get_collection("mvm").load
        channel.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out.decode()
    assert b"server started" in out and b"bye" in out
    assert (tmp_path / "objects" / "mvm" / "mvm.vertex").exists()


def test_build_servicer_modes():
    cfg = Config()
    cfg.serving.device = "cpu"
    assert build_servicer("experimental", cfg).SERVICE.endswith(
        "ExperimentalMultiVectorService")
    cfg.serving.shards = 2
    engine = build_servicer("experimental", cfg).engine
    assert engine.mesh.shape["shard"] == 2
    with pytest.raises(ValueError, match="unknown mode"):
        build_servicer("nope", Config())

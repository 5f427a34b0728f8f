"""Engine-level multi-device serving of the port vs the JAX package.

The cases of ``tests/test_engine_sharded.py`` on both packages: each
engine built over a 4-shard mesh (the reference's ``make_mesh(4)`` of
``tests/conftest.py``'s CPU devices, the port's four ``cpu`` shards) takes
the same collections and rows and must answer as the other package and
as its own one-device engine. Then checkpoints cross packages and
layouts: a sharded JAX engine's objects load into a sharded and a
one-device port engine, and the reverse.

Tolerances, stated once: the same pks at every rank and scores within
1e-5 on the 0-100 scale, or two f32 ulps of the score (the scans sum in
another order; ``tests/test_torch_parallel.py``). A quantized store gets
f16-valued queries, which the JAX store sends its device anyway. PQ
codebooks cannot be trained alike (``jax.random`` against a
``torch.Generator``), so a PQ collection is held to the port's one-device
engine, as the reference holds its own: the shards' shortlists hold
``k x 4`` rows each, one device's ``k x 4`` in all, so the sharded result
reranks more rows and may be better; pk overlap >= 0.9.
"""

import io

import numpy as np
import pytest
import torch

from coltt_tpu.engine.edge import EdgeEngine as JEdgeEngine
from coltt_tpu.engine.experimental import ExperimentalEngine as JExpEngine
from coltt_tpu.index.schema import CollectionSchema as JSchema
from coltt_tpu.parallel.mesh import make_mesh as jmesh
from coltt_tpu.storage.objectstore import LocalObjectStore as JObjectStore
from coltt_tpu_torch.engine.edge import EdgeEngine
from coltt_tpu_torch.engine.experimental import ExperimentalEngine
from coltt_tpu_torch.index.schema import CollectionSchema, FieldSchema, FieldType
from coltt_tpu_torch.ops.pq import train_pq
from coltt_tpu_torch.parallel.mesh import ShardedRows, make_mesh
from coltt_tpu_torch.storage.objectstore import LocalObjectStore
from coltt_tpu_torch.store.flat import FlatStore

torch.set_num_threads(2)

SHARDS = 4


def tmesh(shards=SHARDS):
    return make_mesh(shards, devices=["cpu"] * shards)


def _schema(name, dim=32, quantization="none", metric="cosine"):
    return {"name": name, "dim": dim, "metric": metric, "quantization": quantization,
            "fields": [{"name": "pk", "type": "string", "primary_key": True},
                       {"name": "tag", "type": "string"}]}


def _engines(tmp_path, sub="e"):
    """(JAX over 4 shards, port over 4 shards, port on one device), each
    over its own object-store directory."""
    root = tmp_path / sub
    return (JEdgeEngine(JObjectStore(str(root / "jax")), batch_max=0,
                        mesh=jmesh(SHARDS), precompile_batches=()),
            EdgeEngine(LocalObjectStore(str(root / "port")), device="cpu",
                       mesh=tmesh(), batch_max=0, warmup_batches=()),
            EdgeEngine(LocalObjectStore(str(root / "one")), device="cpu",
                       batch_max=0, warmup_batches=()))


def _create(engines, schema):
    for e in engines:
        cls = JSchema if isinstance(e, JEdgeEngine) else CollectionSchema
        e.create_collection(cls.from_dict(schema))


def _ingest(engine, name, vecs, tags):
    engine.index_many(name, [{"pk": f"p{i}", "tag": tags[i]} for i in range(len(vecs))],
                      vecs)


@pytest.fixture
def corpus():
    rng = np.random.default_rng(0)
    n, dim = 3000, 32
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    tags = [("a" if i % 3 == 0 else "b") for i in range(n)]
    queries = rng.standard_normal((8, dim)).astype(np.float16).astype(np.float32)
    return vecs, tags, queries


def _batch(engine, name, queries, **kw):
    """search_batch as (pks [Q][k], scores [Q][k])."""
    counts, scores, pks, _ = engine.search_batch(name, queries, **kw)
    out, i = [], 0
    for c in counts:
        out.append((list(pks[i:i + c]), np.asarray(scores[i:i + c], np.float32)))
        i += c
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gp, gs), (wp, ws) in zip(got, want):
        assert gp == wp
        np.testing.assert_allclose(gs, ws, rtol=2e-7, atol=1e-5)


def _overlap(a, b):
    return np.mean([len(set(x[0]) & set(y[0])) / max(len(y[0]), 1) for x, y in zip(a, b)])


def _is_sharded(store, shards=SHARDS):
    assert isinstance(store.codes, ShardedRows)
    assert store.mesh.shards == shards and len(store.codes.blocks) == shards
    assert store.capacity % (shards * 8192) == 0


def test_edge_sharded_flat_equivalence(tmp_path, corpus):
    vecs, tags, queries = corpus
    engines = _engines(tmp_path)
    _create(engines, _schema("col"))
    for e in engines:
        _ingest(e, "col", vecs, tags)
    j, t, one = (_batch(e, "col", queries, limit=10) for e in engines)
    _same(t, j)
    _same(t, one)
    _is_sharded(engines[1]._collections["col"].store)


def test_edge_sharded_filtered(tmp_path, corpus):
    """A filtered search on a mesh masks the scan on every shard (never the
    gather) and answers as the reference and the one-device engine."""
    vecs, tags, queries = corpus
    expr = {"filter": {"index_name": "tag", "op": "eq", "value": "a"}}
    engines = _engines(tmp_path)
    _create(engines, _schema("col"))
    for e in engines:
        _ingest(e, "col", vecs, tags)
    j, t, one = (_batch(e, "col", queries, limit=10, filter_expression=expr)
                 for e in engines)
    _same(t, j)
    _same(t, one)
    assert all(int(pk[1:]) % 3 == 0 for pks, _ in t for pk in pks)


def test_edge_sharded_mutation_and_growth(tmp_path, corpus):
    """Upserts and deletes after the ingest route to their shards (and
    past the first capacity, which grows and re-cuts the shards); every
    search sees them, as on the reference and one device."""
    vecs, tags, queries = corpus
    engines = _engines(tmp_path)
    _create(engines, _schema("col"))
    probe = np.full(32, 0.5, np.float32)
    rng = np.random.default_rng(9)
    more = rng.standard_normal((34000, 32)).astype(np.float32)
    for e in engines:
        _ingest(e, "col", vecs, tags)
        e.index("col", {"pk": "new", "tag": "z"}, probe)
        assert e.search("col", probe, limit=1)[0].id == "new"
        e.index("col", {"pk": "new"}, delete=True)
        hits = e.search("col", probe, limit=1)
        assert hits and hits[0].id != "new"
        e.index_many("col", [{"pk": f"m{i}", "tag": "m"} for i in range(len(more))], more)
    store = engines[1]._collections["col"].store
    store.sync()
    assert store.capacity == 65536 and store.codes.local_n == 16384
    _is_sharded(store)
    j, t, one = (_batch(e, "col", queries, limit=10) for e in engines)
    _same(t, j)
    _same(t, one)


def test_edge_sharded_bq(tmp_path):
    """N so that the global shortlist and every shard's (k x 64 rows) hold
    every row: the sharded BQ result equals the one-device one."""
    rng = np.random.default_rng(1)
    n, dim = 512, 64
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((4, dim)).astype(np.float16).astype(np.float32)
    engines = _engines(tmp_path)
    _create(engines, _schema("col", dim=dim, quantization="bq"))
    for e in engines:
        _ingest(e, "col", vecs, ["a"] * n)
    j, t, one = (_batch(e, "col", queries, limit=10) for e in engines)
    _same(t, j)
    _same(t, one)


@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_bq_store_sharded_keeps_compute_dtype(compute_dtype):
    """A BQ store over a mesh runs its search with the store's
    ``compute_dtype`` as the one-device store does (one function serves
    both): the same slots and scores, unfiltered, masked and gathered. An
    f32 rerank scores differently from a bf16 one, so a mesh path that
    dropped the dtype would fail the f32 case."""
    rng = np.random.default_rng(5)
    n, dim = 512, 64
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((4, dim)).astype(np.float32)
    mesh, one = (FlatStore(dim, quantization="bq", compute_dtype=compute_dtype, device=d)
                 for d in (tmesh(), "cpu"))
    for st in (mesh, one):
        st.upsert_many([str(i) for i in range(n)], vecs)
    cand = np.arange(0, n, 3)
    for kw in ({}, {"candidates": cand}):
        got, want = mesh.search(queries, 10, **kw), one.search(queries, 10, **kw)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=2e-7, atol=1e-5)
    _is_sharded(mesh)
    bf16 = FlatStore(dim, quantization="bq", device="cpu")
    bf16.upsert_many([str(i) for i in range(n)], vecs)
    same = np.allclose(bf16.search(queries, 10)[0], one.search(queries, 10)[0],
                       rtol=2e-7, atol=1e-5)
    assert same == (compute_dtype == torch.bfloat16)


def test_edge_sharded_pq(tmp_path):
    """PQ-cache collection on a mesh: the f8-cache scan per shard, the
    shard-local exact-PQ rerank, the merge; held to the port's one-device
    engine by pk overlap >= 0.9 (module docstring)."""
    rng = np.random.default_rng(2)
    n, dim = 4096, 64
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((4, dim)).astype(np.float16).astype(np.float32)
    _, t, one = engines = _engines(tmp_path)
    _create(engines[1:], _schema("col", dim=dim, quantization="pq"))
    for e in (t, one):
        _ingest(e, "col", vecs, ["a"] * n)
    rt, r1 = (_batch(e, "col", queries, limit=10) for e in (t, one))
    assert _overlap(rt, r1) >= 0.9
    _is_sharded(t._collections["col"].store)


def test_pq_host_codes_sharded_keeps_the_rerank():
    """A host-codes PQ store over a mesh keeps the exact-PQ rerank, shard
    by shard, as the one-device store does: its results equal those of
    the same store with its codes on the device. The reference's sharded
    host-codes store serves the f8-cache ranking without the rerank
    (``coltt_tpu/store/flat.py:1090``); the port does not copy that."""
    rng = np.random.default_rng(4)
    n, dim = 4096, 64
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((6, dim)).astype(np.float32)
    # one codebook for all, given before the first sync
    cb = train_pq(torch.from_numpy(vecs), m=8, n_centroids=64, iters=4)
    stores = {}
    for name, dev, host in (("mesh-host", tmesh(), True), ("mesh-dev", tmesh(), False),
                            ("one-host", "cpu", True), ("one-dev", "cpu", False)):
        st = FlatStore(dim, device=dev, pq_host_codes=host, quantization="pq",
                       pq_subspaces=8, pq_centroids=64)
        st.codebook = cb
        st.upsert_many([str(i) for i in range(n)], vecs)
        stores[name] = st
    res = {k: st.search(queries, 10, oversample=4) for k, st in stores.items()}
    for a, b in (("mesh-host", "mesh-dev"), ("one-host", "one-dev")):
        np.testing.assert_array_equal(res[a][1], res[b][1])
        np.testing.assert_array_equal(res[a][0], res[b][0])
    plain = stores["mesh-host"].search(queries, 10)  # oversample 1: no rerank
    assert not np.array_equal(plain[0], res["mesh-host"][0])
    assert _overlap([(list(r), None) for r in res["mesh-host"][1]],
                    [(list(r), None) for r in res["one-host"][1]]) >= 0.9


def test_experimental_sharded_cflat(tmp_path):
    """CFLAT over a mesh: per-field rows sharded, ``sharded_cflat_topk``'s
    per-shard scans and merge; the reference's sharded engine's and the
    one-device engine's ids and scores."""
    from coltt_tpu.index.schema import (
        CollectionSchema as JCS, FieldSchema as JFS, FieldType as JFT,
    )

    rng = np.random.default_rng(3)
    dim, n = 16, 512
    a = rng.standard_normal((n, dim)).astype(np.float32)
    b = rng.standard_normal((n, dim)).astype(np.float32)
    mesh = tmesh()
    j = JExpEngine(JObjectStore(str(tmp_path / "j")), mesh=jmesh(SHARDS))
    t = ExperimentalEngine(LocalObjectStore(str(tmp_path / "t")), device="cpu", mesh=mesh)
    one = ExperimentalEngine(LocalObjectStore(str(tmp_path / "o")), device="cpu")
    j.create_collection(JCS(name="mv", dim=dim, fields=[
        JFS("a_vec", JFT.VECTOR), JFS("b_vec", JFT.VECTOR)]))
    for e in (t, one):
        e.create_collection(CollectionSchema(name="mv", dim=dim, fields=[
            FieldSchema("a_vec", FieldType.VECTOR), FieldSchema("b_vec", FieldType.VECTOR)]))
    for e in (j, t, one):
        for i in range(n):
            e.index("mv", f"r{i}", vectors={"a_vec": a[i], "b_vec": b[i]})
    q = [("a_vec", a[37], True, 60.0), ("b_vec", b[37], True, 40.0)]
    hj, ht, h1 = (e.vector_search("mv", q, top_k=5) for e in (j, t, one))
    assert ht[0].id == "r37"
    for other in (hj, h1):
        assert [h.id for h in ht] == [h.id for h in other]
        np.testing.assert_allclose([h.score for h in ht], [h.score for h in other],
                                   rtol=2e-7, atol=1e-5)
    store = t._collections["mv"].store
    assert store.mesh is mesh and isinstance(store.codes["a_vec"], ShardedRows)
    assert len(store.codes["a_vec"].blocks) == SHARDS
    # a delete routes to its shard; release -> load keeps the mesh
    for e in (t, one):
        e.index("mv", "r37", delete=True)
    assert t.vector_search("mv", q, top_k=1)[0].id != "r37"
    t.release_collection("mv")
    t.load_collection("mv")
    again = t.vector_search("mv", q, top_k=5)
    assert [h.id for h in again] == [h.id for h in one.vector_search("mv", q, top_k=5)]
    assert t._collections["mv"].store.mesh is mesh


def test_edge_sharded_flush_load_roundtrip(tmp_path, corpus):
    """release -> load keeps the mesh: the reloaded store is sharded and
    answers as before."""
    vecs, tags, queries = corpus
    _, t, _ = _engines(tmp_path)
    t.create_collection(CollectionSchema.from_dict(_schema("col", quantization="i8")))
    _ingest(t, "col", vecs, tags)
    before = _batch(t, "col", queries, limit=10)
    t.release_collection("col")
    t.load_collection("col")
    _is_sharded(t._collections["col"].store)
    _same(_batch(t, "col", queries, limit=10), before)


@pytest.mark.parametrize("quant", ["i8", "bq"])
def test_checkpoints_cross_packages_and_layouts(tmp_path, corpus, quant):
    """A sharded JAX engine's checkpoint loads into a sharded and a
    one-device port engine, and a sharded port engine's into a sharded
    and a one-device JAX engine; each reader answers as the writer."""
    vecs, tags, queries = corpus
    vecs = vecs[:2000]
    for writer_pkg in ("jax", "port"):
        root = str(tmp_path / writer_pkg)
        if writer_pkg == "jax":
            writer = JEdgeEngine(JObjectStore(root), batch_max=0,
                                 mesh=jmesh(SHARDS), precompile_batches=())
        else:
            writer = EdgeEngine(LocalObjectStore(root), device="cpu", mesh=tmesh(),
                                batch_max=0, warmup_batches=())
        _create([writer], _schema("col", quantization=quant))
        _ingest(writer, "col", vecs, tags)
        writer.index("col", {"pk": "p3"}, delete=True)
        writer.flush("col")
        want = _batch(writer, "col", queries, limit=10)
        if writer_pkg == "jax":
            readers = [EdgeEngine(LocalObjectStore(root), device="cpu", mesh=tmesh(),
                                  batch_max=0, warmup_batches=()),
                       EdgeEngine(LocalObjectStore(root), device="cpu", batch_max=0,
                                  warmup_batches=())]
        else:
            readers = [JEdgeEngine(JObjectStore(root), batch_max=0,
                                   mesh=jmesh(SHARDS), precompile_batches=()),
                       JEdgeEngine(JObjectStore(root), batch_max=0,
                                   precompile_batches=())]
        for reader in readers:
            reader.load_collection("col")
            _same(_batch(reader, "col", queries, limit=10), want)
        if writer_pkg == "jax":
            _is_sharded(readers[0]._collections["col"].store)


def test_store_snapshot_layouts():
    """A sharded store's snapshot is the one-device snapshot of the same
    state: the bytes are equal, and either loads in either layout."""
    rng = np.random.default_rng(6)
    vecs = rng.standard_normal((5000, 64)).astype(np.float32)
    one, four = FlatStore(64, quantization="f8", device="cpu"), FlatStore(
        64, quantization="f8", device=tmesh())
    for st in (one, four):
        st.upsert_many([f"p{i}" for i in range(5000)], vecs)
        st.delete("p7")
    bufs = []
    for st in (one, four):
        buf = io.BytesIO()
        st.save(buf)
        bufs.append(buf.getvalue())
    # the capacities differ (8192 one device, 4 x 8192 on the mesh), the
    # rows they share do not
    a = FlatStore.load(io.BytesIO(bufs[0]), device=tmesh())
    b = FlatStore.load(io.BytesIO(bufs[1]), device="cpu")
    assert a.capacity == four.capacity and b.capacity == four.capacity
    buf = io.BytesIO()
    a.save(buf)
    assert buf.getvalue() == bufs[1]
    q = vecs[:4].astype(np.float16).astype(np.float32)
    for st in (a, b, four):
        np.testing.assert_array_equal(st.search(q, 5)[1], one.search(q, 5)[1])

"""Core engine of both packages: the cases of ``test_core_engine.py`` run
against the JAX package and the port (on CPU tensors) through the ``pkg``
fixture; then the snapshots (``<col>.raw`` / ``<col>.bin``) and the KV
commit log written by one engine are opened by the other."""

import importlib
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

DIM = 16
PKGS = ("coltt_tpu", "coltt_tpu_torch")


def _pkg(root: str) -> SimpleNamespace:
    core = importlib.import_module(f"{root}.engine.core")
    kw = {"device": "cpu"} if root == "coltt_tpu_torch" else {}
    return SimpleNamespace(
        root=root,
        Engine=lambda path, **more: core.CoreEngine(str(path), **kw, **more),
        CoreEngine=core.CoreEngine,
        CollectionSpec=core.CollectionSpec,
        HnswConfig=importlib.import_module(f"{root}.store.hnsw").HnswConfig,
        Metric=importlib.import_module(f"{root}.ops.distance").Metric,
        EngineError=importlib.import_module(f"{root}.engine.errors").EngineError,
    )


@pytest.fixture(params=PKGS)
def pkg(request):
    return _pkg(request.param)


def _spec(pkg, name="c1"):
    return pkg.CollectionSpec(
        name=name, dim=DIM, metric=pkg.Metric.COSINE,
        config=pkg.HnswConfig(m=6, ef_construction=40),
    )


@pytest.fixture
def engine(pkg, tmp_path):
    e = pkg.Engine(tmp_path / "data")
    yield e
    if not e.kv._lock_f.closed:
        e.kv.close()


def _fill(engine, rng, n=30, name="c1"):
    vecs = rng.standard_normal((n, DIM), dtype=np.float32)
    ids = [engine.insert(name, vecs[i], {"tag": f"t{i % 3}", "i": i}, ext_id=f"id{i}")
           for i in range(n)]
    return vecs, ids


def test_lifecycle_and_vector_search(pkg, engine, rng):
    engine.create_collection(_spec(pkg))
    vecs, _ = _fill(engine, rng)
    info = engine.collection_info("c1")
    assert info["size"] == 30 and info["loaded"]
    hits = engine.vector_search("c1", vecs[9], top_k=3)
    assert hits[0].id == "id9"
    assert hits[0].score > 99.9
    assert hits[0].metadata["i"] == 9


def test_insert_duplicate_id_rejected(pkg, engine, rng):
    engine.create_collection(_spec(pkg))
    v = rng.standard_normal(DIM, dtype=np.float32)
    engine.insert("c1", v, {}, ext_id="dup")
    with pytest.raises(pkg.EngineError):
        engine.insert("c1", v, {}, ext_id="dup")


def test_update_and_fallback_insert(pkg, engine, rng):
    engine.create_collection(_spec(pkg))
    _fill(engine, rng, n=10)
    nv = rng.standard_normal(DIM, dtype=np.float32)
    engine.update("c1", "id4", nv, {"tag": "new", "i": 4})
    hits = engine.vector_search("c1", nv, top_k=1)
    assert hits[0].id == "id4" and hits[0].metadata["tag"] == "new"
    engine.update("c1", "brand-new", nv * 2, {"tag": "x", "i": 99})
    assert engine.collection_info("c1")["size"] == 11


def test_delete(pkg, engine, rng):
    engine.create_collection(_spec(pkg))
    vecs, _ = _fill(engine, rng, n=10)
    assert engine.delete("c1", "id5")
    assert not engine.delete("c1", "id5")
    hits = engine.vector_search("c1", vecs[5], top_k=5)
    assert "id5" not in [h.id for h in hits]


def test_filter_and_hybrid_search(pkg, engine, rng):
    engine.create_collection(_spec(pkg))
    vecs, _ = _fill(engine, rng)
    hits = engine.filter_search("c1", {"tag": "t1"}, top_k=30, vector=vecs[1])
    assert hits and all(h.metadata["tag"] == "t1" for h in hits)
    assert hits[0].id == "id1"
    hits = engine.hybrid_search("c1", vecs[4], {"tag": "t1"}, top_k=5)
    assert all(h.metadata["tag"] == "t1" for h in hits)
    assert hits[0].id == "id4"


def test_snapshot_release_load(pkg, engine, rng):
    engine.create_collection(_spec(pkg))
    vecs, _ = _fill(engine, rng, n=20)
    assert "released" in engine.release_collection("c1")
    assert not engine.collection_info("c1")["loaded"]
    engine.load_collection("c1")
    assert engine.vector_search("c1", vecs[8], top_k=1)[0].id == "id8"


def test_crash_recovery_from_commit_log(pkg, tmp_path, rng):
    e1 = pkg.Engine(tmp_path / "data")
    e1.create_collection(_spec(pkg))
    vecs = rng.standard_normal((15, DIM), dtype=np.float32)
    for i in range(15):
        e1.insert("c1", vecs[i], {"i": i}, ext_id=f"id{i}")
    e1.delete("c1", "id3")
    e1.kv._wal.sync()
    e1.kv._lock_f.close()  # crash: no snapshot, the lock dropped

    e2 = pkg.Engine(tmp_path / "data")
    assert e2.state.exists("c1")
    assert e2.load_collection("c1")["size"] == 14  # dirty -> rebuilt from log
    hits = e2.vector_search("c1", vecs[7], top_k=1)
    assert hits[0].id == "id7" and hits[0].metadata["i"] == 7
    assert "id3" not in [h.id for h in e2.vector_search("c1", vecs[3], top_k=14)]
    e2.close()


def test_clean_shutdown_uses_snapshot(pkg, tmp_path, rng):
    e1 = pkg.Engine(tmp_path / "data")
    e1.create_collection(_spec(pkg))
    vecs = rng.standard_normal((10, DIM), dtype=np.float32)
    for i in range(10):
        e1.insert("c1", vecs[i], {"i": i}, ext_id=f"id{i}")
    e1.close()
    e2 = pkg.Engine(tmp_path / "data")
    assert not e2.kv.exists(b"__dirty__c1")
    e2.load_collection("c1")
    assert e2.vector_search("c1", vecs[2], top_k=1)[0].id == "id2"
    e2.close()


def test_drop_collection_removes_everything(pkg, tmp_path, rng):
    e = pkg.Engine(tmp_path / "data")
    e.create_collection(_spec(pkg))
    e.insert("c1", rng.standard_normal(DIM, dtype=np.float32), {}, ext_id="x")
    e.release_collection("c1")
    e.drop_collection("c1")
    assert not e.state.exists("c1")
    assert not e.kv.keys(b"c1\x1f")
    with pytest.raises(pkg.EngineError):
        e.collection_info("c1")
    e.close()


def test_compare_dist(pkg):
    x = np.array([1.0, 0.0], np.float32)
    y = np.array([0.0, 1.0], np.float32)
    assert pkg.CoreEngine.compare_dist(x, x, pkg.Metric.COSINE) == pytest.approx(100.0)
    assert pkg.CoreEngine.compare_dist(x, y, pkg.Metric.COSINE) == pytest.approx(50.0)
    assert pkg.CoreEngine.compare_dist(x, y, pkg.Metric.EUCLIDEAN) == pytest.approx(98.0)


def test_compare_dist_agrees_across_packages(rng):
    j, t = (_pkg(p) for p in PKGS)
    for _ in range(5):
        x, y = rng.standard_normal((2, 64), dtype=np.float32)
        for m in (0, 1):
            assert t.CoreEngine.compare_dist(x, y, m) == pytest.approx(
                j.CoreEngine.compare_dist(x, y, m), rel=0, abs=1e-4)


def test_dimension_validation(pkg, engine):
    engine.create_collection(_spec(pkg))
    with pytest.raises(pkg.EngineError):
        engine.insert("c1", np.zeros(3, np.float32), {})


def test_min_score_threshold(pkg, engine, rng):
    engine.create_collection(_spec(pkg))
    vecs, _ = _fill(engine, rng, n=10)
    all_hits = engine.vector_search("c1", vecs[0], top_k=10)
    thresh = all_hits[1].score + 0.01
    few = engine.vector_search("c1", vecs[0], top_k=10, min_score=thresh)
    assert len(few) < len(all_hits)
    assert all(h.score >= thresh for h in few)


def test_bulk_insert_empty_collection(pkg, engine, rng):
    engine.create_collection(_spec(pkg))
    n = 300
    vecs = rng.standard_normal((n, DIM), dtype=np.float32)
    mds = [{"tag": f"t{i % 3}", "i": i} for i in range(n)]
    ids = engine.bulk_insert("c1", vecs, mds, ext_ids=[f"b{i}" for i in range(n)])
    assert len(ids) == n and ids[5] == "b5"
    assert engine.collection_info("c1")["size"] == n
    hits = engine.vector_search("c1", vecs[42], top_k=3)
    assert hits[0].id == "b42" and hits[0].metadata["i"] == 42
    hits = engine.filter_search("c1", {"tag": "t1"}, top_k=5, vector=vecs[1])
    assert hits and all(h.metadata["tag"] == "t1" for h in hits)


def test_bulk_insert_nonempty_falls_back(pkg, engine, rng):
    engine.create_collection(_spec(pkg))
    _fill(engine, rng, n=5)
    vecs = rng.standard_normal((4, DIM), dtype=np.float32)
    engine.bulk_insert("c1", vecs, ext_ids=[f"x{i}" for i in range(4)])
    assert engine.collection_info("c1")["size"] == 9
    assert engine.vector_search("c1", vecs[2], top_k=1)[0].id == "x2"


def test_bulk_insert_survives_restart(pkg, tmp_path, rng):
    e = pkg.Engine(tmp_path / "data")
    e.create_collection(_spec(pkg))
    vecs = rng.standard_normal((50, DIM), dtype=np.float32)
    e.bulk_insert("c1", vecs, ext_ids=[f"r{i}" for i in range(50)])
    e.kv.close()  # crash: no snapshot written
    e2 = pkg.Engine(tmp_path / "data")
    e2.load_collection("c1")  # replays the commit log
    assert e2.vector_search("c1", vecs[7], top_k=1)[0].id == "r7"
    e2.close()


def test_bulk_insert_validation(pkg, engine, rng):
    engine.create_collection(_spec(pkg))
    with pytest.raises(pkg.EngineError):
        engine.bulk_insert("c1", rng.standard_normal((3, DIM + 1)).astype(np.float32))
    with pytest.raises(pkg.EngineError):
        engine.bulk_insert("c1", rng.standard_normal((2, DIM)).astype(np.float32),
                           ext_ids=["a", "a"])


def test_port_engine_raises_without_cuda(tmp_path, monkeypatch):
    """The port's engine serves on CUDA by default and refuses to start
    when there is none: no quiet fallback to the CPU."""
    from coltt_tpu_torch.engine.core import CoreEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CoreEngine(str(tmp_path / "data"))


# -- across packages ----------------------------------------------------------------

def _ids(e, queries, k=5):
    return [[h.id for h in e.vector_search("c1", q, top_k=k)] for q in queries]


@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]])
def test_snapshots_open_in_the_other_package(writer, reader, tmp_path, rng):
    """A collection released (``<col>.raw`` + ``<col>.bin``) and closed by
    one engine loads in the other with the same graph: the same ids and
    metadata; the reader's own mutations then go back."""
    w, r = _pkg(writer), _pkg(reader)
    e = w.Engine(tmp_path / "data")
    e.create_collection(_spec(w))
    vecs, _ = _fill(e, rng, n=60)
    e.delete("c1", "id11")
    qs = rng.standard_normal((8, DIM), dtype=np.float32)
    want = _ids(e, qs)
    e.close()

    e2 = r.Engine(tmp_path / "data")
    assert not e2.kv.exists(b"__dirty__c1")  # loads the snapshot, not the log
    assert e2.load_collection("c1")["size"] == 59
    assert _ids(e2, qs) == want
    hits = e2.filter_search("c1", {"tag": "t2"}, top_k=5, vector=vecs[2])
    assert hits[0].id == "id2" and hits[0].metadata == {"tag": "t2", "i": 2}
    e2.insert("c1", vecs[0] * 3, {"tag": "late"}, ext_id="late")
    e2.close()

    e3 = w.Engine(tmp_path / "data")
    e3.load_collection("c1")
    assert e3.collection_info("c1")["size"] == 60
    assert e3.vector_search("c1", vecs[0] * 3, top_k=1)[0].id in ("late", "id0")
    e3.close()


@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]])
def test_commit_log_rebuilds_in_the_other_package(writer, reader, tmp_path, rng):
    """A crash leaves only the KV commit log: the other package rebuilds the
    collection from it, with the same graph as the writer's own rebuild
    (sequential inserts in key order, bit-identical on the host)."""
    w, r = _pkg(writer), _pkg(reader)
    e = w.Engine(tmp_path / "data")
    e.create_collection(_spec(w))
    vecs, _ = _fill(e, rng, n=40)
    e.update("c1", "id8", vecs[9] + 0.1, {"tag": "moved"})
    e.delete("c1", "id20")
    e.kv._wal.sync()
    e.kv._lock_f.close()  # crash
    shutil.copytree(tmp_path / "data", tmp_path / "copy")

    qs = rng.standard_normal((8, DIM), dtype=np.float32)
    results = []
    for p, path in ((r, tmp_path / "data"), (w, tmp_path / "copy")):
        e2 = p.Engine(path)
        assert e2.load_collection("c1")["size"] == 39
        results.append((_ids(e2, qs), e2.vector_search("c1", vecs[9] + 0.1, top_k=1)[0]))
        e2.close()
    assert results[0][0] == results[1][0]
    assert results[0][1].id == "id8" and results[0][1].metadata == {"tag": "moved"}

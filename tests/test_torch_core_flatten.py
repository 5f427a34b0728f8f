"""Core engine's batch flatten on the CPU (``engine/core.py``
``vector_search_batch``): its answers against the JAX package's per-hit
loop, run on the same HNSW search output from the port's snapshot, and the
id column (``_CoreCollection.id_col``, the port's one slot -> id map)
against ``id_to_slot`` after every path that writes it."""

import numpy as np
import pytest

from coltt_tpu.engine.core import CoreEngine as JaxCoreEngine
from coltt_tpu_torch.engine.core import CollectionSpec, CoreEngine
from coltt_tpu_torch.engine.errors import EngineError
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.store.hnsw import HnswConfig
from coltt_tpu_torch.utils import trace

NAME, DIM, ROWS, K = "c1", 16, 300, 10
# rows of the bulk replay: 4,097 records in the log after one delete, past
# the replay's sequential branch
REPLAY_BULK = 4098


def _open(path):
    return CoreEngine(str(path), device="cpu")


def _create(engine):
    engine.create_collection(CollectionSpec(
        name=NAME, dim=DIM, metric=Metric.COSINE,
        config=HnswConfig(m=6, ef_construction=40)))


def _rows(n=ROWS, seed=0):
    return np.random.default_rng(seed).standard_normal((n, DIM), dtype=np.float32)


def _bulk(engine, vecs):
    engine.bulk_insert(NAME, vecs, [{"tag": f"t{i % 3}", "i": i} for i in range(len(vecs))],
                       ext_ids=[f"r{i}" for i in range(len(vecs))])


def _crash(engine, path):
    """Drop ``engine`` without a snapshot and open its data anew: the
    collection is dirty, so loading it replays the commit log."""
    engine.kv._wal.sync()
    engine.kv._lock_f.close()
    engine = _open(path)
    engine.load_collection(NAME)
    return engine


def _jax_answer(path, queries, d, ids, **kw):
    """The JAX package's ``vector_search_batch`` (one Python step a hit) on
    the collection the port snapshotted at ``path``, its HNSW search
    answering ``(d, ids)``: the same slots, ids and metadata."""
    engine = JaxCoreEngine(str(path))
    try:
        engine.load_collection(NAME)
        engine._collections[NAME].hnsw.search = lambda queries, k, ef=None: (d, ids)
        return engine.vector_search_batch(NAME, queries, **kw)
    finally:
        engine.close()


def _served(engine, queries, monkeypatch, *, top_k=K, min_score=0.0,
            with_metadata=False, search_k=None):
    """``vector_search_batch``'s answer, the HNSW search output it flattened,
    and the growth of ``engine.flatten_rows``; ``search_k`` widens the
    search's output past ``top_k`` columns."""
    col = engine._collections[NAME]
    seen = []
    search = col.hnsw.search

    def recorded(queries, k, **kw):
        seen.append(search(queries, k=search_k or k, **kw))
        return seen[-1]

    monkeypatch.setattr(col.hnsw, "search", recorded)
    before = trace.counters().get("engine.flatten_rows", 0)
    got = engine.vector_search_batch(NAME, queries, top_k=top_k, min_score=min_score,
                                     with_metadata=with_metadata)
    grown = trace.counters()["engine.flatten_rows"] - before
    monkeypatch.setattr(col.hnsw, "search", search)
    (searched,) = seen
    return got, searched, grown


def _mutate(engine, path, vecs):
    engine.delete(NAME, "r5")
    old = engine._collections[NAME].id_to_slot["r7"]
    engine.update(NAME, "r7", vecs[7] + 0.05, {"tag": "moved", "i": 7})
    assert engine._collections[NAME].id_to_slot["r7"] != old
    return engine


def _reload(engine, path, vecs):
    engine.release_collection(NAME)
    engine.load_collection(NAME)
    return engine


def _replay(engine, path, vecs):
    return _crash(_mutate(engine, path, vecs), path)


FLATTEN_CASES = {
    "plain": dict(),
    "min_score": dict(min_score="median"),
    "short_rows": dict(top_k=ROWS + 20),
    "wider_search": dict(search_k=K + 6),
    "metadata": dict(with_metadata=True),
    "delete_update": dict(before=_mutate, with_metadata=True),
    "snapshot_load": dict(before=_reload),
    "log_replay": dict(before=_replay),
}


@pytest.mark.parametrize("case", list(FLATTEN_CASES))
def test_flatten_matches_the_per_hit_loop(case, tmp_path, monkeypatch):
    opts = dict(FLATTEN_CASES[case])
    vecs = _rows()
    engine = _open(tmp_path / "data")
    _create(engine)
    _bulk(engine, vecs)
    engine = opts.pop("before", lambda e, p, v: e)(engine, tmp_path / "data", vecs)
    queries = np.concatenate([vecs[:40] + 0.01, _rows(24, seed=1)])
    if opts.get("min_score") == "median":
        got = engine.vector_search_batch(NAME, queries, top_k=K)[1]
        # just above an f32 score: an f32 comparison would keep that hit
        opts["min_score"] = float(np.nextafter(np.sort(got)[len(got) // 2], np.inf))
        assert np.float32(opts["min_score"]) in np.float32(got)
    try:
        got, (d, ids), grown = _served(engine, queries, monkeypatch, **opts)
    finally:
        engine.close()   # the snapshot the JAX package opens
    opts.pop("search_k", None)
    opts.setdefault("top_k", K)
    assert got == _jax_answer(tmp_path / "data", queries, d, ids, **opts)
    assert grown == len(got[2]) == sum(got[0])
    assert "" not in got[2]
    if case == "min_score":
        assert any(0 < c < K for c in got[0])
        assert min(got[1]) >= opts["min_score"]
    if case == "wider_search":
        assert ids.shape[1] > K and max(got[0]) == K
    if case == "short_rows":
        assert (ids < 0).any() and max(got[0]) <= ROWS < opts["top_k"]
    if case in ("delete_update", "log_replay"):
        assert "r5" not in got[2]
        assert got[2][7 * K] == "r7"
    if case == "delete_update":
        assert got[3][7 * K] == {"tag": "moved", "i": 7}


def _slot_to_id(col):
    return {s: i for i, s in col.id_to_slot.items()}


def _consistent(col):
    n, by_slot = len(col.id_col), _slot_to_id(col)
    assert len(by_slot) == len(col.id_to_slot) and all(s < n for s in by_slot)
    assert col.id_col.tolist() == [by_slot.get(s, "") for s in range(n)]


class _FailingBatch:
    """A KV batch whose commit raises; the rollback's own batches commit."""
    failed = False

    def __init__(self, batch):
        self._batch = batch

    def __getattr__(self, name):
        return getattr(self._batch, name)

    def commit(self):
        if _FailingBatch.failed:
            return self._batch.commit()
        _FailingBatch.failed = True
        raise OSError("commit refused")


def _fail_commits(engine, monkeypatch):
    """The next KV commit of ``engine`` fails."""
    new_batch = engine.kv.new_batch
    monkeypatch.setattr(_FailingBatch, "failed", False)
    monkeypatch.setattr(engine.kv, "new_batch", lambda: _FailingBatch(new_batch()))


def _insert(engine, path, monkeypatch):
    vecs = _rows(40)
    for i, v in enumerate(vecs):
        engine.insert(NAME, v, {"i": i}, ext_id=f"r{i}")
    assert len(engine._collections[NAME].id_col) == 64  # doubled from 1
    return engine


def _insert_rollback(engine, path, monkeypatch):
    _insert(engine, path, monkeypatch)
    _fail_commits(engine, monkeypatch)
    with pytest.raises(EngineError, match="rolled back"):
        engine.insert(NAME, _rows(1, seed=2)[0], {}, ext_id="lost")
    assert "lost" not in engine._collections[NAME].id_to_slot
    return engine


def _bulk_insert(engine, path, monkeypatch):
    _bulk(engine, _rows())
    assert len(engine._collections[NAME].id_col) == ROWS
    return engine


def _bulk_rollback(engine, path, monkeypatch):
    _fail_commits(engine, monkeypatch)
    with pytest.raises(EngineError, match="rolled back"):
        _bulk(engine, _rows())
    monkeypatch.undo()
    assert len(engine._collections[NAME].id_col) == 0
    _bulk(engine, _rows(50))
    return engine


def _grow_past_bulk(engine, path, monkeypatch):
    _bulk_insert(engine, path, monkeypatch)
    engine.bulk_insert(NAME, _rows(3, seed=3), ext_ids=["x0", "x1", "x2"])
    assert len(engine._collections[NAME].id_col) == 2 * ROWS
    return engine


def _delete(engine, path, monkeypatch):
    _bulk_insert(engine, path, monkeypatch)
    assert engine.delete(NAME, "r9") and engine.delete(NAME, f"r{ROWS - 1}")
    return engine


def _update(engine, path, monkeypatch):
    _bulk_insert(engine, path, monkeypatch)
    engine.update(NAME, "r3", _rows(1, seed=4)[0], {"i": 3})
    engine.update(NAME, "fresh", _rows(1, seed=5)[0], {"i": -1})
    return engine


def _snapshot_load(engine, path, monkeypatch):
    _delete(engine, path, monkeypatch)
    engine.release_collection(NAME)
    engine.load_collection(NAME)
    return engine


def _replay_inserts(engine, path, monkeypatch):
    return _crash(_delete(engine, path, monkeypatch), path)


def _replay_bulk(engine, path, monkeypatch):
    _bulk(engine, _rows(REPLAY_BULK))
    engine.delete(NAME, "r9")
    return _crash(engine, path)


COLUMN_PATHS = {
    "insert": _insert,
    "insert_rollback": _insert_rollback,
    "bulk_insert": _bulk_insert,
    "bulk_insert_rollback": _bulk_rollback,
    "grow_past_bulk": _grow_past_bulk,
    "delete": _delete,
    "update": _update,
    "snapshot_load": _snapshot_load,
    "log_replay_inserts": _replay_inserts,
    "log_replay_bulk": _replay_bulk,
}


@pytest.mark.parametrize("path_name", list(COLUMN_PATHS))
def test_id_column_follows_slot_to_id(path_name, tmp_path, monkeypatch):
    engine = _open(tmp_path / "data")
    _create(engine)
    engine = COLUMN_PATHS[path_name](engine, tmp_path / "data", monkeypatch)
    monkeypatch.undo()
    try:
        col = engine._collections[NAME]
        _consistent(col)
        slots = np.arange(len(col.id_col) + 3)
        assert col.ids_at(slots) == [_slot_to_id(col).get(s, "") for s in slots.tolist()]
    finally:
        engine.close()

"""The port's HNSW index against the JAX package's: host construction bit
for bit, snapshots byte for byte both ways, device search on a graph the
reference built, the loop forms, and the cases of ``test_hnsw.py`` on the
port (CPU tensors)."""

import io
import threading

import msgpack
import numpy as np
import pytest
import torch

from coltt_tpu.ops.distance import Metric as JMetric
from coltt_tpu.store.hnsw import HnswConfig as JConfig
from coltt_tpu.store.hnsw import HnswIndex as JIndex
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.store import hnsw
from coltt_tpu_torch.store.convert import hnsw_index_from_arrays, hnsw_index_to_arrays
from coltt_tpu_torch.store.hnsw import HEURISTIC, HnswConfig, HnswIndex


def _brute_topk(vecs, q, k, metric=Metric.COSINE, exclude=()):
    if metric == Metric.COSINE:
        d = 1 - (vecs @ q) / (np.linalg.norm(q) * np.linalg.norm(vecs, axis=1) + 1e-30)
    else:
        d = ((vecs - q) ** 2).sum(1)
    d = d.copy()
    for e in exclude:
        d[e] = np.inf
    return np.argsort(d)[:k]


def _recall(vecs, qs, ids, metric=Metric.COSINE, exclude=()):
    hits = sum(len(set(_brute_topk(vecs, q, 10, metric, exclude))
                   & {int(x) for x in row if x >= 0})
               for q, row in zip(qs, ids))
    return hits / (10 * len(qs))


def _pair(dim, cfg: dict, metric=Metric.COSINE, seed=1):
    """A reference and a port index with the same config and seed."""
    j = JIndex(dim, metric=JMetric(int(metric)), config=JConfig(**cfg), seed=seed)
    t = HnswIndex(dim, metric=metric, config=HnswConfig(**cfg), seed=seed, device="cpu")
    return j, t


def _same_graph(a, b):
    n = a._next
    assert b._next == n and b._count == a._count
    assert (a._entry, a._max_level) == (b._entry, b._max_level)
    np.testing.assert_array_equal(a._levels[:n], b._levels[:n])
    np.testing.assert_array_equal(a._alive[:n], b._alive[:n])
    np.testing.assert_array_equal(a._vecs[:n], b._vecs[:n])
    assert len(a._adj) == len(b._adj)
    for x, y in zip(a._adj, b._adj):
        np.testing.assert_array_equal(x[:n], y[:n])


def _save(idx) -> bytes:
    buf = io.BytesIO()
    idx.save(buf)
    return buf.getvalue()


@pytest.fixture(scope="module")
def built():
    """A 400 x 24 cosine graph built by both packages from the same inserts,
    a few rows removed."""
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((400, 24), dtype=np.float32)
    j, t = _pair(24, dict(m=8, ef_construction=60))
    for v in vecs:
        j.insert(v)
        t.insert(v)
    for s in (5, 77, 123, t.entrypoint):
        j.remove(s)
        t.remove(s)
    return j, t, vecs


# -- host paths: exact -----------------------------------------------------------

@pytest.mark.parametrize("cfg,metric", [
    (dict(m=8, ef_construction=60), Metric.COSINE),
    (dict(m=6, ef_construction=40, algorithm=HEURISTIC,
          heuristic_extend_candidates=True), Metric.EUCLIDEAN),
    (dict(m=4, ef_construction=20, algorithm=HEURISTIC,
          heuristic_keep_pruned=False), Metric.COSINE),
], ids=["simple-cosine", "heuristic-extend-euclidean", "heuristic-unpruned"])
def test_host_inserts_and_removes_are_bit_identical(cfg, metric):
    rng = np.random.default_rng(13)
    vecs = rng.standard_normal((250, 16), dtype=np.float32)
    j, t = _pair(16, cfg, metric)
    for i, v in enumerate(vecs):
        assert j.insert(v) == t.insert(v)
        if i % 9 == 8:
            assert j.remove(i - 4) == t.remove(i - 4)
    _same_graph(j, t)
    qs = rng.standard_normal((3, 16), dtype=np.float32)
    dj, ij = j.search(qs, 5, ef=32, device=False)
    dt, it = t.search(qs, 5, ef=32, device=False)
    np.testing.assert_array_equal(ij, it)
    np.testing.assert_array_equal(dj, dt)


def test_snapshots_are_byte_identical_both_ways(built):
    j, t, _ = built
    assert _save(j) == _save(t)
    from_ref = HnswIndex.load(io.BytesIO(_save(j)), device="cpu")
    from_port = JIndex.load(io.BytesIO(_save(t)))
    _same_graph(j, from_ref)
    _same_graph(t, from_port)
    assert from_ref.config == t.config
    assert _save(from_ref) == _save(j) == _save(from_port)


def test_load_reads_the_list_form_snapshot(built):
    """Snapshots written before the binary levels / alive fields carried
    them as msgpack lists."""
    j, _, _ = built
    blob = _save(j)
    hlen = int.from_bytes(blob[8:16], "big")
    h = msgpack.unpackb(blob[16:16 + hlen], raw=False)
    n = h["next"]
    h["levels"] = np.frombuffer(h.pop("levels_bin"), "<i4").tolist()
    h["alive"] = np.unpackbits(np.frombuffer(h.pop("alive_bin"), np.uint8),
                               count=n).astype(bool).tolist()
    hb = msgpack.packb(h, use_bin_type=True)
    old = blob[:8] + len(hb).to_bytes(8, "big") + hb + blob[16 + hlen:]
    _same_graph(j, HnswIndex.load(io.BytesIO(old), device="cpu"))


def test_manhattan_raises():
    with pytest.raises(ValueError, match="cosine/euclidean"):
        HnswIndex(8, metric=Metric.MANHATTAN, device="cpu")


def test_config_defaults():
    c = HnswConfig().resolved()
    assert c.m_max == 16 and c.m_max0 == 32 and c.ef == 20
    assert c.ef_construction == 200
    assert abs(c.level_multiplier - 1 / np.log(16)) < 1e-9
    assert c.to_dict() == JConfig().to_dict()


# -- device search on the reference's graph ------------------------------------------

@pytest.mark.parametrize("route", ["arrays", "snapshot"])
def test_device_search_on_a_reference_graph(built, route):
    """The reference's graph carried across (f32): ids equal on >= 99% of
    (query, rank) pairs, distances within 1e-5 (the f32 sums run in
    another order)."""
    j, _, vecs = built
    if route == "arrays":
        state = hnsw_index_to_arrays(j)
        port = hnsw_index_from_arrays(**state, device="cpu")
    else:
        port = HnswIndex.load(io.BytesIO(_save(j)), device="cpu")
    qs = np.random.default_rng(5).standard_normal((64, 24), dtype=np.float32)
    for ef in (20, 64):
        dj, ij = j.search(qs, 10, ef=ef)
        dt, it = port.search(qs, 10, ef=ef)
        assert (ij == it).mean() >= 0.99
        np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)
    assert not {5, 77, 123} & set(it.ravel().tolist())


@pytest.mark.parametrize("check_every", [0, 1, 3])
def test_fixed_count_and_early_exit_loops_are_equal(built, check_every):
    """The loops run their fixed hop count or stop once their condition
    is false, checked every few hops: identical ids and distances."""
    _, t, _ = built
    qs = np.random.default_rng(6).standard_normal((48, 24), dtype=np.float32)
    want = t.search(qs, 10, ef=40)
    old = hnsw.LOOP_CHECK_EVERY
    try:
        hnsw.LOOP_CHECK_EVERY = check_every
        got = t.search(qs, 10, ef=40)
    finally:
        hnsw.LOOP_CHECK_EVERY = old
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    vectors, sqn, adj0, alive, upper = t._device_graph()
    tq = torch.from_numpy(qs)
    entries = torch.full((48,), t.entrypoint, dtype=torch.long)
    walks = [hnsw._greedy_descent(vectors, sqn, adj0, tq, entries, metric=t.metric,
                                  check_every=c) for c in (0, check_every)]
    assert torch.equal(*walks)


def test_bf16_device_graph_close_to_f32(built):
    """A bf16 device graph ranks with bf16 operands and f32 sums: its
    distances stay within bf16 rounding of the f32 graph's."""
    _, t, vecs = built
    b = HnswIndex.load(io.BytesIO(_save(t)), device="cpu", device_dtype=torch.bfloat16)
    qs = np.random.default_rng(8).standard_normal((32, 24), dtype=np.float32)
    d32, i32 = t.search(qs, 10, ef=64)
    d16, i16 = b.search(qs, 10, ef=64)
    assert (i32 == i16).mean() >= 0.9
    np.testing.assert_allclose(d16, d32, rtol=0, atol=2e-2)


# -- test_hnsw.py on the port -----------------------------------------------------------

def test_recall_at_10(built):
    _, t, vecs = built
    qs = np.random.default_rng(3).standard_normal((20, 24), dtype=np.float32)
    _, ids = t.search(qs, k=10, ef=64)
    dead = np.nonzero(~t._alive[:len(vecs)])[0]
    assert _recall(vecs, qs, ids, exclude=dead) >= 0.9


def test_device_matches_host_search(built):
    _, t, _ = built
    qs = np.random.default_rng(5).standard_normal((4, 24), dtype=np.float32)
    dd, _ = t.search(qs, k=5, ef=48, device=True)
    hd, _ = t.search(qs, k=5, ef=48, device=False)
    for i in range(4):
        np.testing.assert_allclose(np.sort(dd[i]), np.sort(hd[i]), atol=1e-3)


def test_remove_excludes_from_results(built):
    _, t, vecs = built
    idx = HnswIndex.load(io.BytesIO(_save(t)), device="cpu")
    target = 200
    assert idx.search(vecs[target], k=1, ef=32)[1][0, 0] == target
    assert idx.remove(target)
    assert not idx.remove(target)
    _, ids = idx.search(vecs[target], k=5, ef=32)
    assert target not in ids[0]
    dead = [target] + [s for s in range(len(vecs)) if not idx._alive[s]]
    assert ids[0, 0] == _brute_topk(vecs, vecs[target], 1, exclude=dead)[0]


def test_remove_entrypoint_recovers():
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((50, 8), dtype=np.float32)
    idx = HnswIndex(8, config=HnswConfig(m=4, ef_construction=20), seed=2, device="cpu")
    for v in vecs:
        idx.insert(v)
    ep = idx.entrypoint
    idx.remove(ep)
    _, ids = idx.search(vecs[10], k=3, ef=16)
    assert (ids[0] >= 0).all()
    assert ep not in ids[0]


def test_heuristic_selection_builds_and_searches():
    rng = np.random.default_rng(13)
    vecs = rng.standard_normal((150, 16), dtype=np.float32)
    cfg = HnswConfig(m=6, ef_construction=40, algorithm=HEURISTIC,
                     heuristic_extend_candidates=True, heuristic_keep_pruned=True)
    idx = HnswIndex(16, metric=Metric.EUCLIDEAN, config=cfg, seed=3, device="cpu")
    for v in vecs:
        idx.insert(v)
    assert idx.search(vecs[77], k=1, ef=32)[1][0, 0] == 77


def test_empty_index_search():
    d, ids = HnswIndex(8, device="cpu").search(np.zeros((2, 8), np.float32), k=3)
    assert (ids == -1).all() and np.isinf(d).all()


def test_ef_below_expand():
    """A serving ef under the beam's expansion width expands ef entries a
    hop (the reference's top_k would refuse it)."""
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((60, 8), dtype=np.float32)
    idx = HnswIndex(8, config=HnswConfig(m=4, ef=4, ef_construction=20), device="cpu")
    for v in vecs:
        idx.insert(v)
    d, ids = idx.search(vecs[:3], k=2)
    assert (ids[:, 0] == np.arange(3)).all() and np.isfinite(d).all()


def test_incremental_device_cache_mutate_search():
    """Mutations write their rows into the capacity-shaped device cache
    instead of rebuilding it; searches see every mutation."""
    rng = np.random.default_rng(5)
    idx = HnswIndex(32, metric=Metric.COSINE, seed=1, device="cpu")
    base = rng.standard_normal((300, 32)).astype(np.float32)
    for v in base:
        idx.insert(v)
    q = rng.standard_normal(32).astype(np.float32)
    _, s0 = idx.search(q, 5)
    cache0 = idx._device_cache
    assert cache0 is not None and cache0[0].shape[0] == idx._vecs.shape[0]

    slot = idx.insert(q * 1.001)
    _, s1 = idx.search(q, 5)
    assert s1[0, 0] == slot
    cache1 = idx._device_cache
    assert cache1 is not None and not idx._dirty
    # no live snapshot: the rows went into the same tensors, in place
    assert cache1[0] is cache0[0] and cache1[2] is cache0[2]

    assert idx.remove(slot)
    _, s2 = idx.search(q, 5)
    assert slot not in s2[0].tolist()
    assert set(s2[0].tolist()) == set(s0[0].tolist())


def test_mutation_never_touches_a_live_snapshot():
    """While a search holds the device graph (``_readers > 0``), dirty rows
    go into copies: the snapshot's tensors keep their contents."""
    rng = np.random.default_rng(9)
    idx = HnswIndex(16, seed=1, device="cpu")
    vecs = rng.standard_normal((120, 16)).astype(np.float32)
    for v in vecs[:100]:
        idx.insert(v)
    with idx._mu:
        snap = idx._device_graph()
        idx._readers += 1
    before = [t.clone() for t in snap[:4]] + [t.clone() for t in snap[4]]
    for v in vecs[100:]:
        idx.insert(v)
    idx.remove(3)
    with idx._mu:
        fresh = idx._device_graph()
        idx._readers -= 1
    after = list(snap[:4]) + list(snap[4])
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert fresh[0] is not snap[0]
    assert bool(fresh[3][100]) and not bool(fresh[3][3]) and bool(snap[3][3])


def test_concurrent_insert_search_stress():
    """Searches racing inserts and removes never crash or return torn
    results."""
    rng = np.random.default_rng(11)
    idx = HnswIndex(16, metric=Metric.EUCLIDEAN, seed=3, device="cpu")
    vecs = rng.standard_normal((600, 16)).astype(np.float32)
    for i in range(200):
        idx.insert(vecs[i], slot=i)
    errors = []
    stop = threading.Event()

    def writer():
        try:
            for i in range(200, 600):
                idx.insert(vecs[i], slot=i)
                if i % 7 == 0:
                    idx.remove(i - 150)
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    def reader():
        qs = rng.standard_normal((4, 16)).astype(np.float32)
        try:
            while not stop.is_set():
                d, s = idx.search(qs, 5)
                ok = s >= 0
                assert (s[ok] < idx._vecs.shape[0]).all()
                assert np.isfinite(d[ok]).all()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert idx._readers == 0
    assert idx.search(vecs[599], 3)[1][0, 0] == 599

"""Port FlatStore vs the JAX FlatStore on the same operations and state.

Both stores take the same upserts and deletes (numpy rows); their codes
must be bit-identical and their norms equal to f32 rounding. Searches run
on one state in both packages (carried over with ``store/convert.py``):
the plain scan, the fused scan, and both filtered regimes must return the
same slots, with scores within 1e-3 on the 0-100 scale (the scans sum in
another order; the fused path adds the packing perturbation, 2^-18 of the
bias). Snapshots written by either package load in the other, and a port
snapshot of a JAX store's state is byte-identical to the JAX snapshot.

The JAX store sends queries to a quantized store's device as f16 (a relay
workaround the port leaves behind), so the queries here are f16 values:
the rounding is then the identity in both packages.
"""

import io

import numpy as np
import pytest
import torch

from coltt_tpu.ops.quant import Quantization as JQuant
from coltt_tpu.store.flat import FlatStore as JFlatStore
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.pq import train_pq
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.store.convert import (
    flat_store_from_arrays,
    flat_store_to_arrays,
    pq_codebook_from_arrays,
)
from coltt_tpu_torch.store.flat import FlatStore

torch.set_num_threads(2)

D = 128
SCORE_TOL = 1e-3


def _jax_arrays(js: JFlatStore) -> dict:
    js.sync()
    return {
        "dim": js.dim,
        "metric": int(js.metric),
        "quantization": int(js.quantization),
        "codes": np.asarray(js.codes),
        "scale": np.asarray(js.scale),
        "sqnorm": np.asarray(js.sqnorm),
        "valid": np.asarray(js.valid),
        "pk_to_slot": dict(js.pk_to_slot),
        "free": list(js._free),
        "next_slot": js._next_slot,
    }


def _mutate(store, rng_seed=0, n=3000):
    """The same upserts, overwrites and deletes for either package."""
    rng = np.random.default_rng(rng_seed)
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    store.upsert_many([f"p{i}" for i in range(n)], vecs)
    for i in range(0, n, 9):
        store.delete(f"p{i}")
    over = rng.standard_normal((50, D)).astype(np.float32)
    store.upsert_many([f"p{i}" for i in range(1, 100, 2)], over)
    store.upsert("late", rng.standard_normal(D).astype(np.float32))
    return vecs


def f16_queries(rng, n):
    return rng.standard_normal((n, D)).astype(np.float16).astype(np.float32)


def assert_same_search(jres, tres, tol=SCORE_TOL):
    """Same hits, rank by rank, up to near-ties: scores agree within
    ``tol`` at every rank, a hit found by one package only must score
    within ``tol`` of the last rank, and two hits may trade places only
    when their scores are within ``tol`` (the sums run in another order)."""
    (js, ji), (ts, ti) = jres, tres
    finite = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), finite)
    np.testing.assert_allclose(ts[finite], js[finite], rtol=0, atol=tol)
    for r in range(ji.shape[0]):
        live = finite[r]
        jd = dict(zip(ji[r][live].tolist(), js[r][live].tolist()))
        td = dict(zip(ti[r][live].tolist(), ts[r][live].tolist()))
        last = js[r][live].min() if live.any() else 0.0
        for pk in set(jd) ^ set(td):
            assert abs(jd.get(pk, td.get(pk)) - last) <= tol, (r, pk)
        for pk in set(jd) & set(td):
            assert abs(jd[pk] - td[pk]) <= tol, (r, pk)


@pytest.mark.parametrize("quant", ["NONE", "F16", "BF16", "F8", "I8"])
def test_mutations_match_jax(quant):
    js = JFlatStore(D, quantization=JQuant[quant])
    ts = FlatStore(D, quantization=Quantization[quant], device="cpu")
    _mutate(js)
    _mutate(ts)
    want = _jax_arrays(js)
    got = flat_store_to_arrays(ts)
    np.testing.assert_array_equal(
        got["codes"].view(np.uint8), np.ascontiguousarray(want["codes"]).view(np.uint8))
    np.testing.assert_array_equal(got["scale"], want["scale"])
    np.testing.assert_allclose(got["sqnorm"], want["sqnorm"], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["pk_to_slot"] == want["pk_to_slot"]
    assert got["free"] == want["free"] and got["next_slot"] == want["next_slot"]
    assert len(ts) == len(js)
    np.testing.assert_allclose(ts.get_vector("p1"), js.get_vector("p1"), rtol=1e-6)
    assert ts.get_vector("p0") is None and js.get_vector("p0") is None


@pytest.mark.parametrize("quant", ["F8", "I8", "NONE"])
@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN],
                         ids=lambda m: m.name)
def test_search_matches_jax_on_same_state(quant, metric):
    js = JFlatStore(D, metric=int(metric), quantization=JQuant[quant])
    vecs = _mutate(js)
    ts = flat_store_from_arrays(**_jax_arrays(js), device="cpu")
    rng = np.random.default_rng(1)
    q = f16_queries(rng, 6)
    q[0] = vecs[4].astype(np.float16)  # ~a stored row: its own slot first
    for fused in (False, True):
        assert_same_search(js.search(q, 10, fused=fused),
                            ts.search(q, 10, fused=fused))
    assert ts.search(q[:1], 1)[1][0, 0] == ts.pk_to_slot["p4"]
    # filtered: few candidates gather the rows, many take the masked scan
    few = np.arange(0, 900, 3, dtype=np.int32)
    many = np.arange(0, 2990, dtype=np.int32)
    for cand in (few, many):
        assert_same_search(js.search(q, 10, candidates=cand),
                            ts.search(q, 10, candidates=cand))
    s, i = ts.search(q, 10, candidates=few)
    assert set(i[i >= 0].tolist()) <= set(few.tolist())
    s, i = ts.search(q, 5, candidates=np.zeros(0, np.int32))
    assert (i == -1).all() and np.isneginf(s).all()


@pytest.mark.parametrize("quant", ["BF16", "F8", "I8"])
def test_snapshots_load_in_both_packages(quant):
    js = JFlatStore(D, quantization=JQuant[quant])
    _mutate(js)
    jbuf = io.BytesIO()
    js.save(jbuf)

    # JAX snapshot -> port: same state, same top-k
    ts = FlatStore.load(io.BytesIO(jbuf.getvalue()), device="cpu")
    q = f16_queries(np.random.default_rng(2), 4)
    assert_same_search(js.search(q, 10), ts.search(q, 10))
    # the port writes the same bytes for the same state
    tbuf = io.BytesIO()
    ts.save(tbuf)
    assert tbuf.getvalue() == jbuf.getvalue()

    # port snapshot of its own mutations -> JAX
    own = FlatStore(D, quantization=Quantization[quant], device="cpu")
    _mutate(own, rng_seed=3)
    obuf = io.BytesIO()
    own.save(obuf)
    back = JFlatStore.load(io.BytesIO(obuf.getvalue()))
    assert_same_search(back.search(q, 10), own.search(q, 10))
    assert back.pk_to_slot == own.pk_to_slot


def test_sync_while_searching_keeps_the_snapshot():
    """A sync during a live search snapshot writes out of place: the
    snapshot's tensors never change under its scan."""
    ts = FlatStore(D, quantization=Quantization.I8, device="cpu")
    _mutate(ts)
    ts.sync()
    snap_codes = ts.codes
    before = snap_codes.clone()
    ts._readers += 1  # a search holds a snapshot
    try:
        ts.upsert("p1", np.ones(D, np.float32))
        ts.sync()
        assert ts.codes is not snap_codes
        assert torch.equal(snap_codes, before)
    finally:
        ts._readers -= 1
    ts.upsert("p3", np.ones(D, np.float32))
    codes = ts.codes
    ts.sync()
    assert ts.codes is codes  # no reader: in place

    # a host-resident PQ code table: the snapshot's numpy table never
    # changes under its shortlist gather either
    hs = FlatStore(D, quantization=Quantization.PQ, device="cpu",
                   pq_host_codes=True, **_PQ_BASE)
    _mutate(hs)
    hs.sync()
    snap_table = hs.pqcodes_host
    before = snap_table.copy()
    hs._readers += 1
    try:
        hs.upsert("p1", np.full(D, 3.0, np.float32))
        hs.upsert("late", -np.ones(D, np.float32))
        hs.sync()
        assert hs.pqcodes_host is not snap_table
        np.testing.assert_array_equal(snap_table, before)
        assert not np.array_equal(hs.pqcodes_host, before)
    finally:
        hs._readers -= 1
    hs.upsert("p3", np.ones(D, np.float32))
    table = hs.pqcodes_host
    hs.sync()
    assert hs.pqcodes_host is table  # no reader: in place


def test_growth_and_unported_modes():
    """Every mode grows past its first capacity, BQ and PQ included (both
    ported now); BQ refuses a metric other than cosine, as the reference."""
    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((8200, D)).astype(np.float32)
    for quant, opts in ((Quantization.I8, {}), (Quantization.BQ, {}),
                        (Quantization.PQ, dict(_PQ_BASE))):
        ts = FlatStore(D, quantization=quant, device="cpu", **opts)
        ts.upsert_many([str(i) for i in range(8200)], vecs)
        s, i = ts.search(vecs[8199:8200], 3, fused=True, oversample=4)
        assert ts.capacity == 16384, quant
        assert (i >= 0).all() and (i < 8200).all() and i[0, 0] == 8199, quant
    with pytest.raises(ValueError, match="cosine-only"):
        FlatStore(D, quantization=Quantization.BQ, metric=Metric.EUCLIDEAN, device="cpu")
    with pytest.raises(ValueError):
        JFlatStore(D, quantization=JQuant.BQ, metric=int(Metric.EUCLIDEAN))


# -- BQ and PQ stores ----------------------------------------------------------

BQ_MODES = {
    # name: (JAX options, port options)
    "bf16-rerank": ({}, {}),
    "f8-rerank": ({"bq_rerank_dtype": JQuant.F8},
                  {"bq_rerank_dtype": Quantization.F8}),
    "no-rerank": ({"bq_rerank": False}, {"bq_rerank": False}),
}
_PQ_BASE = dict(pq_subspaces=8, pq_centroids=64, pq_train_iters=5)
PQ_MODES = {
    "cache-opq": dict(_PQ_BASE, pq_opq_iters=2),
    "adc": dict(_PQ_BASE, pq_cache=False),
    "host-codes-residual": dict(_PQ_BASE, pq_host_codes=True, pq_coarse=16),
}


def _mutate_clustered(store, rng_seed=0, n=3000, grow=6000):
    """Clustered upserts, a sync, deletes, overwrites, then enough rows to
    grow past the first 8192-row capacity (the first sync trains PQ)."""
    rng = np.random.default_rng(rng_seed)
    centers = rng.standard_normal((32, D)).astype(np.float32)

    def rows(m):
        return (centers[rng.integers(0, 32, m)]
                + 0.3 * rng.standard_normal((m, D))).astype(np.float32)

    vecs = rows(n)
    store.upsert_many([f"p{i}" for i in range(n)], vecs)
    store.sync()
    for i in range(0, n, 9):
        store.delete(f"p{i}")
    store.upsert_many([f"p{i}" for i in range(1, 100, 2)], rows(50))
    store.upsert("late", rows(1)[0])
    store.upsert_many([f"g{i}" for i in range(grow)], rows(grow))
    store.sync()
    return vecs


def _jax_state(js: JFlatStore) -> dict:
    """A JAX BQ / PQ store's state and options, for flat_store_from_arrays."""
    out = _jax_arrays(js)
    if js.is_bq:
        out.update(bq_rerank=js.bq_rerank, bq_oversample=js.bq_oversample,
                   bq_rerank_dtype=Quantization(int(js.bq_rr_quant)))
        if js.bq_rerank:
            out.update(rr_codes=np.asarray(js.rr_codes), rr_scale=np.asarray(js.rr_scale))
    if js.is_pq:
        cb = js.codebook
        out.update(pq_subspaces=js.pq_m, pq_centroids=js.pq_centroids,
                   pq_train_iters=js.pq_train_iters, pq_cache=js.pq_cache,
                   pq_host_codes=js.pq_host, pq_opq_iters=js.pq_opq_iters,
                   pq_coarse=js.pq_coarse,
                   codebook={"centroids": np.asarray(cb.centroids),
                             "rotation": None if cb.rotation is None else np.asarray(cb.rotation),
                             "coarse": None if cb.coarse is None else np.asarray(cb.coarse)})
        if js.pq_cache:
            out["pqcodes"] = np.asarray(js._pq_code_array())
    return out


def _queries(seed, n=6):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, D)).astype(np.float16).astype(np.float32)


@pytest.mark.parametrize("mode", list(BQ_MODES))
def test_bq_store_matches_jax(mode):
    jopt, topt = BQ_MODES[mode]
    js = JFlatStore(D, quantization=JQuant.BQ, **jopt)
    ts = FlatStore(D, quantization=Quantization.BQ, device="cpu", **topt)
    vecs = _mutate_clustered(js)
    _mutate_clustered(ts)
    want, got = _jax_state(js), flat_store_to_arrays(ts)
    # sign words and the rerank copy bit-identical, the slot maps equal
    np.testing.assert_array_equal(got["codes"].view(np.uint32), want["codes"])
    if "rr_codes" in want:
        np.testing.assert_array_equal(
            got["rr_codes"].view(np.uint8),
            np.ascontiguousarray(want["rr_codes"]).view(np.uint8))
        np.testing.assert_array_equal(got["rr_scale"], want["rr_scale"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["pk_to_slot"] == want["pk_to_slot"] and ts.capacity == js.capacity == 16384
    assert ts.memory_bytes == js.memory_bytes
    np.testing.assert_allclose(ts.get_vector("p1"), js.get_vector("p1"), rtol=1e-6)

    q = _queries(1)
    q[0] = vecs[4]
    for os_ in (1, 8):
        assert_same_search(js.search(q, 10, oversample=os_),
                           ts.search(q, 10, oversample=os_))
    few = np.arange(0, 900, 3, dtype=np.int32)
    many = np.arange(0, 8000, dtype=np.int32)
    for cand in (few, many):
        assert_same_search(js.search(q, 10, candidates=cand),
                           ts.search(q, 10, candidates=cand))
    # the same state carried across searches the same
    carried = flat_store_from_arrays(**want, device="cpu")
    assert_same_search(js.search(q, 10), carried.search(q, 10))

    # snapshots: the same bytes, loading in the other package
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    js.save(jbuf)
    ts.save(tbuf)
    assert jbuf.getvalue() == tbuf.getvalue()
    back = JFlatStore.load(io.BytesIO(tbuf.getvalue()))
    loaded = FlatStore.load(io.BytesIO(jbuf.getvalue()), device="cpu")
    assert loaded.bq_rerank == ts.bq_rerank and loaded.bq_rr_quant == ts.bq_rr_quant
    assert_same_search(back.search(q, 10), loaded.search(q, 10))


def _pq_pair(opts):
    """A JAX PQ store that trained on its first sync, and a port store
    that took the same mutations with the reference's codebook."""
    js = JFlatStore(D, quantization=JQuant.PQ, **opts)
    _mutate_clustered(js)
    state = _jax_state(js)
    ts = FlatStore(D, quantization=Quantization.PQ, device="cpu", **opts)
    ts.codebook = pq_codebook_from_arrays(**state["codebook"], device="cpu")
    _mutate_clustered(ts)
    return js, ts, state


@pytest.mark.parametrize("mode", list(PQ_MODES))
def test_pq_store_matches_jax(mode):
    js, ts, want = _pq_pair(PQ_MODES[mode])
    got = flat_store_to_arrays(ts)
    key = "pqcodes" if js.pq_cache else "codes"
    same_rows = (got[key] == want[key]).all(axis=1)
    assert same_rows.mean() >= 0.999, same_rows.mean()  # near ties may differ
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["pk_to_slot"] == want["pk_to_slot"] and ts.capacity == js.capacity
    assert ts.memory_bytes == js.memory_bytes
    np.testing.assert_allclose(ts.get_vector("p1"), js.get_vector("p1"), atol=1e-5)

    # searches on one state: the JAX store's, carried across
    carried = flat_store_from_arrays(**want, device="cpu")
    q = _queries(2)
    for os_ in (1, 4):
        for fused in (False, True):
            assert_same_search(js.search(q, 10, oversample=os_, fused=fused),
                               carried.search(q, 10, oversample=os_, fused=fused))
    few = np.arange(0, 900, 3, dtype=np.int32)
    many = np.arange(0, 8000, dtype=np.int32)
    for cand in (few, many):
        assert_same_search(js.search(q, 10, candidates=cand, oversample=4),
                           carried.search(q, 10, candidates=cand, oversample=4))
    s, i = carried.search(q, 10, candidates=few, oversample=4)
    assert set(i[i >= 0].tolist()) <= set(few.tolist())

    # snapshots load in the other package and return the same ids
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    js.save(jbuf)
    ts.save(tbuf)
    loaded = FlatStore.load(io.BytesIO(jbuf.getvalue()), device="cpu")
    # a small code table stays on the device unless the load asks otherwise
    assert loaded.pq_cache == js.pq_cache and not loaded.pq_host
    assert_same_search(js.search(q, 10, oversample=4), loaded.search(q, 10, oversample=4))
    host = FlatStore.load(io.BytesIO(jbuf.getvalue()), device="cpu", pq_host_codes=True)
    assert host.pq_host == js.pq_cache
    assert_same_search(js.search(q, 10, oversample=4), host.search(q, 10, oversample=4))
    back = JFlatStore.load(io.BytesIO(tbuf.getvalue()))
    assert_same_search(back.search(q, 10, oversample=4), ts.search(q, 10, oversample=4))
    # the snapshot's own settings can be overridden at load
    adc = FlatStore.load(io.BytesIO(jbuf.getvalue()), device="cpu", pq_cache=False)
    assert not adc.pq_cache and adc.codes.dtype == torch.uint8


def test_pq_store_trains_on_first_sync_and_bulk_builds():
    """A port PQ store trains its own codebook on its first synced batch;
    bulk_build and adopt_pq give the same state as staged upserts."""
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((3000, D)).astype(np.float32)
    pks = [f"p{i}" for i in range(3000)]
    staged = FlatStore(D, quantization=Quantization.PQ, device="cpu", **PQ_MODES["cache-opq"])
    staged.upsert_many(pks, vecs)
    staged.sync()
    assert staged.codebook is not None and staged.codebook.rotation is not None
    bulk = FlatStore(D, quantization=Quantization.PQ, device="cpu", **PQ_MODES["cache-opq"])
    bulk.codebook = staged.codebook
    bulk.bulk_build(pks, vecs)
    np.testing.assert_array_equal(bulk.pqcodes[:3000].numpy(), staged.pqcodes[:3000].numpy())
    adopted = FlatStore.adopt_pq(staged.codebook, staged.pqcodes, device="cpu")
    q = vecs[:4]
    for store in (bulk, adopted):
        np.testing.assert_array_equal(store.search(q, 5, oversample=4)[1][:, 0],
                                      staged.search(q, 5, oversample=4)[1][:, 0])
    assert [staged.slot_to_pk[int(s)] for s in staged.search(q, 1, oversample=4)[1][:, 0]] \
        == pks[:4]


# -- the slot-indexed key column -----------------------------------------------

def _col_upsert(rng):
    ts = FlatStore(D, device="cpu")
    for i in range(40):
        ts.upsert(f"p{i}", rng.standard_normal(D).astype(np.float32))
    ts.upsert("p7", rng.standard_normal(D).astype(np.float32))  # an overwrite
    return ts


def _col_upsert_many(rng):
    ts = FlatStore(D, device="cpu")
    ts.upsert_many([f"p{i}" for i in range(40)], rng.standard_normal((40, D)))
    ts.upsert_many(["p3", "new", "p9"], rng.standard_normal((3, D)))
    return ts


def _col_delete_reuse(rng):
    ts = FlatStore(D, device="cpu")
    _mutate(ts, n=300)
    freed = ts.delete("p5")
    assert ts.upsert("reuse", rng.standard_normal(D)) == freed
    return ts


def _col_bulk_build(rng):
    ts = FlatStore(D, quantization=Quantization.I8, device="cpu")
    ts.bulk_build([f"b{i}" for i in range(500)], rng.standard_normal((500, D)))
    return ts


def _col_grow(rng):
    ts = FlatStore(D, quantization=Quantization.I8, device="cpu")
    ts.upsert_many([f"p{i}" for i in range(8000)], rng.standard_normal((8000, D)))
    ts.delete("p17")
    ts.upsert_many([f"g{i}" for i in range(300)], rng.standard_normal((300, D)))
    assert ts.capacity == 16384
    return ts


def _col_load(rng):
    ts = FlatStore(D, quantization=Quantization.I8, device="cpu")
    _mutate(ts, n=300)
    buf = io.BytesIO()
    ts.save(buf)
    return FlatStore.load(io.BytesIO(buf.getvalue()), device="cpu")


def _col_adopt_pq(rng):
    cb = train_pq(rng.standard_normal((512, D)).astype(np.float32), m=8,
                  n_centroids=16, iters=2)
    codes = rng.integers(0, 16, (8192, 8)).astype(np.uint8)
    return FlatStore.adopt_pq(cb, codes, device="cpu")


def _col_convert(rng):
    js = JFlatStore(D, quantization=JQuant.I8)
    _mutate(js, n=300)
    return flat_store_from_arrays(**_jax_arrays(js), device="cpu")


KEY_COLUMN_WRITERS = {
    "upsert": _col_upsert, "upsert_many": _col_upsert_many,
    "delete_reuse": _col_delete_reuse, "bulk_build": _col_bulk_build,
    "grow": _col_grow, "load": _col_load, "adopt_pq": _col_adopt_pq,
    "convert": _col_convert,
}


def _assert_key_column(store):
    want = np.full(store.capacity, "", object)
    for slot, pk in store.slot_to_pk.items():
        want[slot] = pk
    assert store.pk_col.tolist() == want.tolist()
    slots = np.arange(store.capacity)
    assert store.pks_at(slots) == [store.slot_to_pk.get(s, "") for s in range(store.capacity)]


@pytest.mark.parametrize("writer", list(KEY_COLUMN_WRITERS))
def test_key_column_stays_in_step(writer):
    """The slot-indexed key column holds slot_to_pk's key at every live slot
    and "" elsewhere, after each writer of the slot maps and after a
    delete and an insert that follow it."""
    rng = np.random.default_rng(11)
    store = KEY_COLUMN_WRITERS[writer](rng)
    assert len(store.slot_to_pk) > 1
    _assert_key_column(store)
    pk = next(iter(store.pk_to_slot))
    freed = store.delete(pk)
    assert store.pks_at(np.array([freed])) == [""]
    _assert_key_column(store)
    store.upsert("after", rng.standard_normal(store.dim).astype(np.float32))
    _assert_key_column(store)
    assert store.pks_at(np.array([store.pk_to_slot["after"]])) == ["after"]

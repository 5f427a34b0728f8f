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
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.store.convert import flat_store_from_arrays, flat_store_to_arrays
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


def test_growth_and_unported_modes():
    ts = FlatStore(D, quantization=Quantization.I8, device="cpu")
    rng = np.random.default_rng(4)
    ts.upsert_many([str(i) for i in range(8200)],
                   rng.standard_normal((8200, D)).astype(np.float32))
    assert ts.capacity == 16384
    s, i = ts.search(rng.standard_normal((2, D)).astype(np.float32), 3, fused=True)
    assert (i >= 0).all() and (i < 8200).all()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FlatStore(D, quantization=Quantization.PQ, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FlatStore(D, quantization=Quantization.BQ, device="cpu")

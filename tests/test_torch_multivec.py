"""Port MultiVectorStore (CFLAT) vs the JAX MultiVectorStore.

The reference's ``tests/test_multivec.py`` cases run against the port's
store. Then both packages take the same upserts, deletes and overwrites
(numpy rows from a seed) and must agree: codes bit-identical, scales
equal, norms equal to f32 rounding; searches on that state agree on the
scores, within rtol 1e-5 for NONE (f32 products in another order) and
1e-3 on the 0-100 scale for the quantized stores (bf16 operands, f32 sums
in another order), and on the ids except among reference scores within
that tolerance of each other. Ties are exact: a euclidean store whose
scores all clip to 0 returns the reference's ids (lower slot first), one
block or several. ``CTTMVEC1`` snapshots load in both packages, byte for
byte. The JAX MultiVectorStore sends f32 queries, so the queries here are
plain f32.
"""

import io

import numpy as np
import pytest
import torch
from test_torch_flat_store import assert_same_search

from coltt_tpu.ops.quant import Quantization as JQuant
from coltt_tpu.parallel import dist_search as jds
from coltt_tpu.parallel.mesh import make_mesh
from coltt_tpu.store.multivec import MultiVectorStore as JStore
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.parallel import dist_search as tds
from coltt_tpu_torch.store.convert import (
    multivec_store_from_arrays,
    multivec_store_to_arrays,
)
from coltt_tpu_torch.store.multivec import MultiVectorStore

torch.set_num_threads(2)

FIELDS = {"title": 16, "body": 32}
K = 10
# scores on the 0-100 scale (bf16 operands; NONE is held to rtol 1e-5 too)
TOL = 1e-3


# -- the reference's cases, on the port ----------------------------------------

def _mk(rng, n=60):
    store = MultiVectorStore(FIELDS, metric=Metric.COSINE, device="cpu")
    data = {
        name: rng.standard_normal((n, dim), dtype=np.float32)
        for name, dim in FIELDS.items()
    }
    for i in range(n):
        store.upsert(f"pk{i}", {name: data[name][i] for name in FIELDS})
    return store, data


def test_weighted_search_prefers_weighted_field(rng):
    store, data = _mk(rng)
    scores, slots = store.search([("title", data["title"][7], 100.0)], k=1)
    assert store.slot_to_pk[int(slots[0])] == "pk7"
    assert scores[0] > 99.0


def test_weighted_sum_matches_manual(rng):
    store, data = _mk(rng, n=40)
    qt = rng.standard_normal(16, dtype=np.float32)
    qb = rng.standard_normal(32, dtype=np.float32)
    scores, slots = store.search([("title", qt, 60.0), ("body", qb, 40.0)], k=5)

    def cos_score(q, v):
        c = 1 - (v @ q) / (np.linalg.norm(q) * np.linalg.norm(v, axis=1))
        return ((2 - c) / 2) * 100

    manual = 0.6 * cos_score(qt, data["title"]) + 0.4 * cos_score(qb, data["body"])
    want = np.argsort(-manual)[:5]
    assert [store.slot_to_pk[int(s)] for s in slots] == [f"pk{i}" for i in want]
    np.testing.assert_allclose(scores, np.sort(manual)[::-1][:5], rtol=1e-4)


def test_excluded_field_is_omitted(rng):
    store, data = _mk(rng, n=20)
    scores, slots = store.search([("body", data["body"][3], 100.0)], k=1)
    assert store.slot_to_pk[int(slots[0])] == "pk3"


def test_search_batch_matches_single(rng):
    store, data = _mk(rng, n=50)
    nq = 7
    qt = rng.standard_normal((nq, 16), dtype=np.float32)
    qb = rng.standard_normal((nq, 32), dtype=np.float32)
    bs, bslots = store.search_batch([("title", qt, 60.0), ("body", qb, 40.0)], k=4)
    assert bs.shape == (nq, 4) and bslots.shape == (nq, 4)
    for q in range(nq):
        ss, sslots = store.search([("title", qt[q], 60.0), ("body", qb[q], 40.0)], k=4)
        np.testing.assert_array_equal(bslots[q], sslots)
        np.testing.assert_allclose(bs[q], ss, rtol=1e-5)


def test_search_batch_validation(rng):
    store, _ = _mk(rng, n=10)
    with pytest.raises(ValueError, match="same Q"):
        store.search_batch(
            [("title", np.zeros((2, 16), np.float32), 50.0),
             ("body", np.zeros((3, 32), np.float32), 50.0)], k=2)
    with pytest.raises(ValueError, match="query block"):
        store.search_batch([("title", np.zeros((16,), np.float32), 100.0)], k=2)
    with pytest.raises(ValueError, match="unknown"):
        store.search_batch([("nope", np.zeros((2, 16), np.float32), 100.0)], k=2)
    with pytest.raises(ValueError, match="at least one"):
        store.search_batch([], k=2)


def test_upsert_delete(rng):
    store, data = _mk(rng, n=10)
    assert len(store) == 10
    store.delete("pk4")
    assert len(store) == 9
    _, slots = store.search([("title", data["title"][4], 100.0)], k=1)
    assert store.slot_to_pk.get(int(slots[0])) != "pk4"


def test_validation(rng):
    store, _ = _mk(rng, n=4)
    with pytest.raises(ValueError):
        store.upsert("x", {"title": np.zeros(16, np.float32)})  # missing body
    with pytest.raises(ValueError):
        store.upsert("x", {"title": np.zeros(16), "body": np.zeros(32),
                           "zzz": np.zeros(4)})
    with pytest.raises(ValueError):
        store.upsert("x", {"title": np.zeros(99), "body": np.zeros(32)})
    with pytest.raises(ValueError):
        store.search([], k=1)
    with pytest.raises(ValueError):
        store.search([("nope", np.zeros(16), 100.0)], k=1)
    with pytest.raises(ValueError, match="query dim"):
        store.search([("title", np.zeros(17), 100.0)], k=1)


def test_snapshot_roundtrip(rng):
    store, data = _mk(rng, n=30)
    store.delete("pk2")
    buf = io.BytesIO()
    store.save(buf)
    buf.seek(0)
    back = MultiVectorStore.load(buf, device="cpu")
    assert back.pk_to_slot == store.pk_to_slot
    q = [("title", data["title"][9], 50.0), ("body", data["body"][9], 50.0)]
    s1, i1 = store.search(q, k=3)
    s2, i2 = back.search(q, k=3)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)


# -- the port against the reference on the same state -------------------------

def _mutate(store, seed=0, n=200):
    """The same upserts, deletes and overwrites for either package."""
    rng = np.random.default_rng(seed)
    data = {f: rng.standard_normal((n, d)).astype(np.float32)
            for f, d in FIELDS.items()}
    for i in range(n):
        store.upsert(f"p{i}", {f: data[f][i] for f in FIELDS})
    store.sync()
    for i in range(0, n, 7):
        store.delete(f"p{i}")
    for i in range(1, 60, 4):  # overwrites, and reuses of freed slots
        store.upsert(f"p{i}", {f: rng.standard_normal(d).astype(np.float32)
                               for f, d in FIELDS.items()})
    store.upsert("late", {f: data[f][3] * 2.0 for f in FIELDS})
    return data


def _jax_arrays(js: JStore) -> dict:
    js.sync()
    return {
        "fields": dict(js.fields),
        "metric": int(js.metric),
        "quantization": int(js.quantization),
        "codes": {f: np.asarray(c) for f, c in js.codes.items()},
        "scale": {f: np.asarray(s) for f, s in js.scale.items()},
        "sqnorm": {f: np.asarray(s) for f, s in js.sqnorm.items()},
        "valid": np.asarray(js.valid),
        "pk_to_slot": dict(js.pk_to_slot),
        "free": list(js._free),
        "next_slot": js._next_slot,
    }


def _queries(seed, nq):
    rng = np.random.default_rng(seed)
    return {f: rng.standard_normal((nq, d)).astype(np.float32)
            for f, d in FIELDS.items()}


def _assert_search(jres, tres, quant):
    (js, ji), (ts, ti) = jres, tres
    np.testing.assert_array_equal(ji < 0, ti < 0)
    if quant == "NONE":
        live = np.isfinite(js)
        np.testing.assert_allclose(ts[live], js[live], rtol=1e-5, atol=0)
    assert_same_search((js, ji), (ts, ti), tol=TOL)


@pytest.mark.parametrize("quant", ["NONE", "F16", "BF16", "F8", "I8"])
def test_mutations_match_jax(quant):
    js = JStore(FIELDS, quantization=JQuant[quant])
    ts = MultiVectorStore(FIELDS, quantization=Quantization[quant], device="cpu")
    _mutate(js)
    _mutate(ts)
    want = _jax_arrays(js)
    got = multivec_store_to_arrays(ts)
    for f in FIELDS:
        np.testing.assert_array_equal(
            got["codes"][f].view(np.uint8),
            np.ascontiguousarray(want["codes"][f]).view(np.uint8))
        np.testing.assert_array_equal(got["scale"][f], want["scale"][f])
        np.testing.assert_allclose(got["sqnorm"][f], want["sqnorm"][f],
                                   rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for key in ("pk_to_slot", "free", "next_slot", "fields"):
        assert got[key] == want[key], key
    assert len(ts) == len(js) and ts.memory_bytes == js.memory_bytes


@pytest.mark.parametrize("quant", ["NONE", "BF16", "F8", "I8"])
@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN],
                         ids=lambda m: m.name)
def test_search_matches_jax_on_same_state(quant, metric):
    js = JStore(FIELDS, metric=int(metric), quantization=JQuant[quant])
    data = _mutate(js)
    ts = multivec_store_from_arrays(**_jax_arrays(js), device="cpu")
    q = _queries(1, 6)
    q["title"][0], q["body"][0] = data["title"][6], data["body"][6]
    for fields in (("title", "body"), ("body",)):
        ratios = {"title": 70.0, "body": 30.0} if len(fields) == 2 else {"body": 100.0}
        jb = js.search_batch([(f, q[f], ratios[f]) for f in fields], k=K)
        tb = ts.search_batch([(f, q[f], ratios[f]) for f in fields], k=K)
        _assert_search(jb, tb, quant)
        for r in (0, 3):
            js1 = js.search([(f, q[f][r], ratios[f]) for f in fields], k=K)
            ts1 = ts.search([(f, q[f][r], ratios[f]) for f in fields], k=K)
            _assert_search((js1[0][None], js1[1][None]),
                           (ts1[0][None], ts1[1][None]), quant)
    _, slots = ts.search([("title", q["title"][0], 50.0),
                          ("body", q["body"][0], 50.0)], k=1)
    assert slots[0] == ts.pk_to_slot["p6"]


def _far_rows_store(pkg):
    """A euclidean store whose every score clips to 0: each row lies more
    than 10 from any query, so 100 - d^2 < 0. Slots 2 and 5 are dead."""
    rng = np.random.default_rng(7)
    n = 120
    data = {f: (rng.standard_normal((n, d)) + 40.0).astype(np.float32)
            for f, d in FIELDS.items()}
    if pkg == "jax":
        store = JStore(FIELDS, metric=int(Metric.EUCLIDEAN))
    else:
        store = MultiVectorStore(FIELDS, metric=Metric.EUCLIDEAN, device="cpu")
    for i in range(n):
        store.upsert(f"p{i}", {f: data[f][i] for f in FIELDS})
    store.delete("p2")
    store.delete("p5")
    return store


def test_euclidean_zero_scores_tie_as_the_reference():
    js, ts = _far_rows_store("jax"), _far_rows_store("port")
    q = _queries(2, 5)
    query = [("title", q["title"], 60.0), ("body", q["body"], 40.0)]
    jb, tb = js.search_batch(query, k=K), ts.search_batch(query, k=K)
    assert (jb[0] == 0).all() and (tb[0] == 0).all()
    want = [0, 1, 3, 4] + list(range(6, 12))  # lower slot first, dead skipped
    assert (jb[1] == want).all()
    np.testing.assert_array_equal(tb[1], jb[1])
    single = ts.search([(f, v[0], r) for f, v, r in query], k=K)
    np.testing.assert_array_equal(single[1], jb[1][0])


def _field_state(store):
    return tuple((store.codes[f], store.scale[f], store.sqnorm[f]) for f in FIELDS)


@pytest.mark.parametrize("case", ["random", "zero-ties"])
def test_blocks_merge_as_one_block(case):
    """A block size forced small (several blocks, the merge) gives what
    one block gives: the same ids and scores, ties lower slot first."""
    if case == "random":
        ts = MultiVectorStore(FIELDS, quantization=Quantization.F8, device="cpu")
        _mutate(ts)
    else:
        ts = _far_rows_store("port")
    ts.sync()
    q = _queries(3, 9)
    queries = tuple(torch.from_numpy(q[f]) for f in FIELDS)
    kw = dict(k=K, metric=ts.metric, compute_dtype=ts.compute_dtype)
    one = tds.sharded_cflat_topk("cpu", _field_state(ts), ts.valid, queries,
                                 (0.7, 0.3), **kw)
    for block in (16, 37, 100):
        got = tds.sharded_cflat_topk("cpu", _field_state(ts), ts.valid, queries,
                                     (0.7, 0.3), block_rows=block, **kw)
        torch.testing.assert_close(got[0], one[0], rtol=0, atol=0)
        assert torch.equal(got[1], one[1]), block


@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN],
                         ids=lambda m: m.name)
def test_sharded_cflat_topk_matches_reference(metric):
    """The one-device sharded_cflat_topk against the reference's at mesh
    size 1, on the same state."""
    js = JStore(FIELDS, metric=int(metric), quantization=JQuant.BF16)
    _mutate(js, seed=4)
    state = _jax_arrays(js)
    ts = multivec_store_from_arrays(**state, device="cpu")
    q = _queries(5, 8)
    jfs = tuple((js.codes[f], js.scale[f], js.sqnorm[f]) for f in FIELDS)
    import jax.numpy as jnp

    jv, ji = jds.sharded_cflat_topk(
        make_mesh(num_shards=1, batch=1), jfs, js.valid,
        tuple(jnp.asarray(q[f]) for f in FIELDS),
        (jnp.float32(0.6), jnp.float32(0.4)), k=K, metric=int(metric),
        compute_dtype=jnp.bfloat16)
    tv, ti = tds.sharded_cflat_topk(
        "cpu", _field_state(ts), ts.valid,
        tuple(torch.from_numpy(q[f]) for f in FIELDS), (0.6, 0.4), k=K,
        metric=metric, compute_dtype=torch.bfloat16)
    assert tv.shape == ti.shape == (8, K) and ti.dtype == torch.int32
    assert_same_search((np.asarray(jv), np.asarray(ji)),
                       (tv.numpy(), ti.numpy()), tol=TOL)
    # several devices: the same state over a two-shard CPU mesh gives
    # the one-device result (the shard-major merge keeps the tie order)
    from coltt_tpu_torch.parallel.mesh import make_mesh as tmesh

    sv, si = tds.sharded_cflat_topk(
        tmesh(2, devices=["cpu", "cpu"]), _field_state(ts), ts.valid,
        tuple(torch.from_numpy(q[f]) for f in FIELDS), (0.6, 0.4), k=K,
        metric=metric, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(sv, tv, rtol=0, atol=0)
    assert torch.equal(si, ti)


@pytest.mark.parametrize("quant", ["BF16", "F8", "I8"])
def test_snapshots_load_in_both_packages(quant):
    js = JStore(FIELDS, quantization=JQuant[quant])
    _mutate(js)
    jbuf = io.BytesIO()
    js.save(jbuf)
    # JAX snapshot -> port: the same bytes back, the same search
    ts = MultiVectorStore.load(io.BytesIO(jbuf.getvalue()), device="cpu")
    tbuf = io.BytesIO()
    ts.save(tbuf)
    assert tbuf.getvalue() == jbuf.getvalue()
    q = _queries(6, 4)
    query = [("title", q["title"], 50.0), ("body", q["body"], 50.0)]
    _assert_search(js.search_batch(query, k=K), ts.search_batch(query, k=K), quant)

    # the port's own mutations -> JAX: loads, answers alike, same bytes back
    own = MultiVectorStore(FIELDS, quantization=Quantization[quant], device="cpu")
    _mutate(own, seed=9)
    obuf = io.BytesIO()
    own.save(obuf)
    back = JStore.load(io.BytesIO(obuf.getvalue()))
    assert back.pk_to_slot == own.pk_to_slot
    _assert_search(back.search_batch(query, k=K), own.search_batch(query, k=K), quant)
    bbuf = io.BytesIO()
    back.save(bbuf)
    assert bbuf.getvalue() == obuf.getvalue()


def test_growth_and_sync_under_a_snapshot():
    """Growth past the first capacity keeps every record; a sync during a
    live search snapshot writes out of place."""
    ts = MultiVectorStore(FIELDS, device="cpu")
    rng = np.random.default_rng(11)
    rows = {f: rng.standard_normal((8200, d)).astype(np.float32)
            for f, d in FIELDS.items()}
    for i in range(8200):
        ts.upsert(str(i), {f: rows[f][i] for f in FIELDS})
    _, slots = ts.search([(f, rows[f][8199], 50.0) for f in FIELDS], k=1)
    assert ts.capacity == 16384 and slots[0] == 8199
    snap = dict(ts.codes), ts.valid
    before = {f: t.clone() for f, t in snap[0].items()}
    ts._readers += 1
    try:
        ts.upsert("0", {f: np.ones(d, np.float32) for f, d in FIELDS.items()})
        ts.delete("1")
        ts.sync()
        assert all(ts.codes[f] is not snap[0][f] for f in FIELDS)
        assert all(torch.equal(snap[0][f], before[f]) for f in FIELDS)
        assert ts.valid is not snap[1] and bool(snap[1][1])
    finally:
        ts._readers -= 1
    codes = ts.codes["title"]
    ts.upsert("2", {f: np.ones(d, np.float32) for f, d in FIELDS.items()})
    ts.sync()
    assert ts.codes["title"] is codes  # no reader: in place


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        MultiVectorStore(FIELDS, device="cuda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the store's tensors live on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["NONE", "F8", "I8"])
def test_store_on_the_card_matches_the_cpu(cuda_device, quant):
    ts = MultiVectorStore(FIELDS, quantization=Quantization[quant], device="cpu")
    _mutate(ts)
    state = multivec_store_to_arrays(ts)
    cs = MultiVectorStore(FIELDS, quantization=Quantization[quant],
                          device=cuda_device)
    _mutate(cs)
    got = multivec_store_to_arrays(cs)
    for f in FIELDS:
        np.testing.assert_array_equal(got["codes"][f].view(np.uint8),
                                      state["codes"][f].view(np.uint8))
    q = _queries(8, 6)
    query = [("title", q["title"], 70.0), ("body", q["body"], 30.0)]
    _assert_search(ts.search_batch(query, k=K), cs.search_batch(query, k=K), quant)
    buf = io.BytesIO()
    cs.save(buf)
    back = MultiVectorStore.load(io.BytesIO(buf.getvalue()), device="cpu")
    _assert_search(ts.search_batch(query, k=K), back.search_batch(query, k=K), quant)

"""The sharded scans of the port vs the JAX package's on the CPU.

The reference runs on ``tests/conftest.py``'s 8-device JAX CPU mesh
(``make_mesh(8)``, ``make_mesh(4, batch=2)``, ``make_mesh(4)``), its K1 and
K2 interpreted; the port on meshes of as many ``cpu`` shards, its kernels'
plain versions. Inputs come from ``np.random.default_rng``; where the two
packages must scan the same codes, the JAX index's arrays are carried to
the port as numpy (``parallel/convert.py``), cut into the port's shards.
Every port sharded result is also held against the port's one-device
result on the same rows.

Tolerances, stated once:

- ids equal at every rank, and scores within 1e-5 absolute on the 0-100
  scale (a cosine distance within 2e-7; the f32 sums over D run in
  another order), or two f32 ulps of the score (2e-7 relative: 1.5e-5
  near 100, where one ulp is 7.6e-6); euclidean scores, whose squared distances reach ~2*D
  and carry f32 rounding of that size, also within 2e-6 relative (a few
  ulps of the score); where ranks hold exact ties (Hamming distances, PQ
  rows with equal codes) the tied ids compare as sets;
- a K1 scan (``fused=True``): the one-packing-step rule of
  ``tests/test_torch_scan.py``: a reference key may sit one packing step
  from the port's, so raw K1 distances agree within 1e-4 (5e-3 on the
  0-100 scale); reranked results are held to the rule above;
- the port's sharded result against its one-device result: equal ids and
  equal scores (with the rule above where the batch axis splits the
  queries: a matrix product of fewer rows may round in another order),
  except where the shards' per-shard shortlists keep other
  members than one global shortlist (BQ with a rerank copy): there, each
  recall against the exact scan.

Shapes are small: N <= 8192 rows, Q <= 16; D = 64, or 128 where K1 and K2
need ``D % 128 == 0``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coltt_tpu.ops.distance import Metric as JMetric
from coltt_tpu.ops.quant import Quantization as JQuant
from coltt_tpu.parallel import dist_search as jds
from coltt_tpu.parallel.mesh import batch_spec, make_mesh as jmesh, shard_spec
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.ops.topk import compute_recall
from coltt_tpu_torch.parallel import dist_search as tds
from coltt_tpu_torch.parallel.convert import (
    flat_index_from_arrays,
    flat_index_to_arrays,
    pq_index_from_arrays,
)
from coltt_tpu_torch.parallel.mesh import SHARD_AXIS, ShardedRows, make_mesh
from coltt_tpu_torch.store.convert import _from_bits, pq_codebook_from_arrays

torch.set_num_threads(2)

K = 10
TOL = 1e-5       # 0-100 scores
ULPS = 2e-7      # two f32 ulps of a score
K1_TOL = 5e-3    # raw K1 scores: 1e-4 of a distance, times 50


def tmesh(shards, batch=1):
    """A port mesh of ``shards x batch`` cpu devices."""
    return make_mesh(shards, batch=batch, devices=["cpu"] * (shards * batch))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, d = 4096, 64
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.standard_normal((8, d), dtype=np.float32))


def _jax_arrays(idx):
    host = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return dict(
        dim=idx.dim, metric=int(idx.metric), quantization=int(idx.quantization),
        n=idx.n, codes=host(idx.codes), valid=host(idx.valid),
        scale=host(getattr(idx, "scale", None)), sqnorm=host(getattr(idx, "sqnorm", None)),
        rr_codes=host(idx.rr_codes),
        gscale=host(idx.gscale) if idx.unit_i8 else None,
        bin_live=host(idx.bin_live) if idx.unit_i8 else None,
    )


def _same(tres, jres, atol=TOL, ties=False, rtol=ULPS):
    """Equal ids at every rank (as sets within ranks of equal score when
    ``ties``), scores within ``atol`` (or ``rtol``)."""
    (ts, ti), (js, ji) = tres, jres
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=rtol, atol=atol)
    if not ties:
        np.testing.assert_array_equal(ti, ji)
        return
    for r in range(ji.shape[0]):
        for v in np.unique(js[r]):
            assert set(ti[r][js[r] == v]) == set(ji[r][js[r] == v]) or v == js[r, -1]


def _identical(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


# -- meshes ----------------------------------------------------------------------

def test_mesh_shapes():
    m = tmesh(8)
    assert m.shape[SHARD_AXIS] == 8 and m.shape["batch"] == 1 and m.size == 8
    m = make_mesh(batch=2, devices=["cpu"] * 8)
    assert m.shape[SHARD_AXIS] == 4 and m.shape["batch"] == 2
    with pytest.raises(ValueError):
        make_mesh(num_shards=16, batch=2, devices=["cpu"] * 8)
    assert jmesh().shape["shard"] == 8  # the reference's 8 devices
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_sharded_rows_scatter_grow_and_snapshot():
    """Rows route to their shard; an out-of-place write leaves the old
    blocks (a live snapshot's) untouched and keeps untouched shards;
    growth re-cuts the blocks with the same global rows."""
    mesh = tmesh(4)
    x = torch.arange(32, dtype=torch.float32).reshape(16, 2)
    sr = ShardedRows.place(mesh, x)
    assert sr.shape == (16, 2) and sr.local_n == 4
    old = [row[0] for row in sr.blocks]
    slots = np.array([1, 6, 7, 13])
    new = sr.scatter(slots, -torch.ones(4, 2), inplace=False)
    assert torch.equal(torch.cat(old), x)  # the snapshot's blocks
    assert new.blocks[2][0] is old[2]       # shard 2 untouched, kept
    want = x.clone()
    want[slots] = -1
    assert torch.equal(new.cpu(), want)
    grown = new.regrow(32, fill=7.0)
    assert grown.local_n == 8 and torch.equal(grown.cpu()[:16], want)
    assert (grown.cpu()[16:] == 7).all() and torch.equal(grown.row(6), want[6])


# -- the flat index ----------------------------------------------------------------

@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN], ids=lambda m: m.name)
def test_sharded_equals_reference_and_one_device(data, metric):
    vecs, qs = data
    j = jds.DistributedFlatIndex(jmesh(), vecs, metric=int(metric))
    t = tds.DistributedFlatIndex(tmesh(8), vecs, metric=metric)
    assert t.codes.shape == tuple(j.codes.shape) and t.codes.local_n == 4096
    _same(t.search(qs, K), j.search(qs, K),
          rtol=2e-6 if metric == Metric.EUCLIDEAN else ULPS)
    _identical(t.search(qs, K), tds.DistributedFlatIndex("cpu", vecs, metric=metric)
               .search(qs, K))


def test_sharded_with_batch_axis_and_odd_queries(data):
    vecs, qs = data
    j = jds.DistributedFlatIndex(jmesh(4, batch=2), vecs)
    t = tds.DistributedFlatIndex(tmesh(4, batch=2), vecs)
    one = tds.DistributedFlatIndex("cpu", vecs)
    for nq in (8, 3):  # 3 does not divide batch=2: padded, then cut
        got = t.search(qs[:nq], 5)
        assert got[0].shape == (nq, 5)
        _same(got, j.search(qs[:nq], 5))
        _same(got, one.search(qs[:nq], 5))


def test_unpadded_row_count(data):
    vecs, qs = data
    odd = np.concatenate([vecs, vecs[:1] * 100.0])  # 4097 rows
    t = tds.DistributedFlatIndex(tmesh(8), odd)
    scores, ids = t.search(qs, K)
    assert ((ids >= 0) & (ids < len(odd))).all()
    _same((scores, ids), jds.DistributedFlatIndex(jmesh(), odd).search(qs, K))


@pytest.mark.parametrize("quant", ["F8", "I8", "BF16"])
def test_quantized_sharded(data, quant):
    vecs, qs = data
    j = jds.DistributedFlatIndex(jmesh(), vecs, quantization=JQuant[quant])
    t = tds.DistributedFlatIndex(tmesh(8), vecs, quantization=Quantization[quant])
    np.testing.assert_array_equal(flat_index_to_arrays(t)["codes"],
                                  np.asarray(j.codes).view(np.int8 if quant != "BF16"
                                                           else np.int16))
    _same(t.search(qs, K), j.search(qs, K))
    exact = tds.DistributedFlatIndex(tmesh(8), vecs).search(qs, K)[1]
    assert compute_recall(t.search(qs, K)[1], exact) >= 0.8


def test_rerank_restores_fp32_ranking(rng):
    """f8 scan + f32 rerank per shard, before the merge (the reference's
    ``rr_codes`` body): the reference's ids, recall@10 >= 0.99."""
    n, d = 8192, 128
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((16, d)).astype(np.float32)
    truth = np.argsort(-(qs @ vecs.T) / np.linalg.norm(vecs, axis=1), axis=1)[:, :K]
    j = jds.DistributedFlatIndex(jmesh(), vecs, quantization=JQuant.F8,
                                 rerank_dtype=jnp.float32)
    t = tds.DistributedFlatIndex(tmesh(8), vecs, quantization=Quantization.F8,
                                 rerank_dtype=torch.float32)
    got = t.search(qs, K, oversample=8)
    _same(got, j.search(qs, K, oversample=8))
    assert compute_recall(got[1], truth) >= 0.99
    raw = t.search(qs, K)[1]
    assert compute_recall(got[1], truth) >= compute_recall(raw, truth)


@pytest.mark.parametrize("quant", ["I8", "F8"])
def test_fused_sharded_matches_reference(rng, quant):
    """K1 on every shard (its plain version here) under the merge: the raw
    fused top-k by the one-packing-step rule, and with the bf16 rerank
    the reference's ids and scores; K1 runs once per shard."""
    from coltt_tpu_torch.ops import fused_scan as fs

    n, d = 8192, 128
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((16, d)).astype(np.float16).astype(np.float32)
    j = jds.DistributedFlatIndex(jmesh(4), vecs, quantization=JQuant[quant],
                                 rerank_dtype=jnp.bfloat16)
    t = flat_index_from_arrays(**_jax_arrays(j), rerank_dtype=torch.bfloat16,
                               device=tmesh(4))
    calls = []
    real = fs.binmax_scan_ref
    fs.binmax_scan_ref = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        raw = t.search(qs, K, fused=True, final="approx")
    finally:
        fs.binmax_scan_ref = real
    assert len(calls) == 4  # one K1 scan per shard
    _same(raw, j.search(qs, K, fused=True, final="approx"), atol=K1_TOL)
    rr = t.search(qs, K, oversample=4, fused=True)
    _same(rr, j.search(qs, K, oversample=4, fused=True))
    one = flat_index_from_arrays(**flat_index_to_arrays(t), device="cpu")
    assert compute_recall(rr[1], one.search(qs, K, oversample=4, fused=True)[1]) >= 0.9


def test_bypass_single_false_runs_the_shard_body(data):
    """``bypass_single=False`` runs the shard body and the merge on a
    one-device mesh and agrees exactly with the bypass, fused or not (the
    reference's check of the same switch)."""
    vecs, qs = data
    mesh = tmesh(1)
    codes = torch.from_numpy(vecs)
    scale = torch.ones((len(vecs), 1))
    sqnorm = (codes * codes).sum(dim=1)
    valid = torch.ones(len(vecs), dtype=torch.bool)
    jm = jmesh(1, devices=jax.devices()[:1])
    for fused in (False, True):
        kw = dict(k=K, metric=Metric.COSINE, compute_dtype=torch.float32, fused=fused)
        direct = tds.sharded_scan_topk(mesh, codes, scale, sqnorm, valid,
                                       torch.from_numpy(qs), **kw)
        body = tds.sharded_scan_topk(mesh, codes, scale, sqnorm, valid,
                                     torch.from_numpy(qs), bypass_single=False, **kw)
        _identical(tuple(x.numpy() for x in direct), tuple(x.numpy() for x in body))
        js = jds.sharded_scan_topk(
            jm, jnp.asarray(vecs), jnp.asarray(scale.numpy()), jnp.asarray(sqnorm.numpy()),
            jnp.ones(len(vecs), bool), jnp.asarray(qs), k=K, metric=JMetric.COSINE,
            compute_dtype=jnp.float32, fused=fused, bypass_single=False)
        _same(tuple(x.numpy() for x in body), tuple(np.asarray(x) for x in js))


# -- unit-i8 (K2) --------------------------------------------------------------------

@pytest.mark.parametrize("shards", [8, 1])
def test_unit_i8_matches_reference(rng, shards):
    """K2 per shard with ONE global scale: on the reference's carried
    state, its ids and scores; recall@10 >= 0.9 against the f32 scan on
    the port's own ingest, whose scale is the global one too."""
    n, d = 8192, 128
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((16, d)).astype(np.float32)
    kw = dict(quantization=JQuant.I8, rerank_dtype=jnp.bfloat16, unit_i8=True)
    j = jds.DistributedFlatIndex(jmesh(shards), vecs, **kw)
    mesh = tmesh(shards)
    carried = flat_index_from_arrays(**_jax_arrays(j), rerank_dtype=torch.bfloat16,
                                     device=mesh)
    _same(carried.search(qs, K, oversample=4), j.search(qs, K, oversample=4))
    own = tds.DistributedFlatIndex(mesh, vecs, quantization=Quantization.I8,
                                   rerank_dtype=torch.bfloat16, unit_i8=True)
    one = tds.DistributedFlatIndex("cpu", vecs, quantization=Quantization.I8,
                                   rerank_dtype=torch.bfloat16, unit_i8=True)
    gscales = {float(g) for g in own.gscale.values()} if shards > 1 else {float(
        next(iter(own.gscale.values())))}
    assert gscales == {float(one.gscale)}  # global, not per shard
    scores, ids = own.search(qs, K, oversample=4)
    exact = tds.DistributedFlatIndex("cpu", vecs).search(qs, K)[1]
    assert compute_recall(ids, exact) >= 0.9
    assert ((ids >= 0) & (ids < n)).all()
    assert (scores[:, :-1] >= scores[:, 1:] - 1e-4).all()
    _identical((scores, ids), one.search(qs, K, oversample=4))


def test_unit_i8_never_returns_padding_rows_sharded(rng):
    """Every valid row scores a negative cosine, so zero-code padding rows
    win their bins on every shard: the mask before the rerank keeps them
    out, as in the reference."""
    n, d, k = 1000, 128, 5  # 8 shards x 4096 rows: mostly padding
    base = np.abs(rng.standard_normal((n, d))).astype(np.float32)
    q = -np.abs(rng.standard_normal((2, d))).astype(np.float32)
    t = tds.DistributedFlatIndex(tmesh(8), base, quantization=Quantization.I8,
                                 rerank_dtype=torch.bfloat16, unit_i8=True)
    scores, ids = t.search(q, k)
    finite = np.isfinite(scores)
    assert ((ids >= 0) & (ids < n))[finite].all() and (ids[~finite] == -1).all()
    j = jds.DistributedFlatIndex(jmesh(), base, quantization=JQuant.I8,
                                 rerank_dtype=jnp.bfloat16, unit_i8=True)
    np.testing.assert_array_equal(np.isfinite(j.search(q, k)[0]), finite)
    s2, i2 = t.search(base[3:4], k)
    assert i2[0, 0] == 3 and np.isfinite(s2[0, 0])


# -- BQ --------------------------------------------------------------------------------

def test_bq_sharded_no_rerank_equals_reference_and_global_hamming(rng):
    """Each shard's exact Hamming top-k merged equals the global Hamming
    top-k: the reference's scores, tied ids as sets, and the numpy
    distance multiset."""
    n, d = 8192, 128
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((6, d)).astype(np.float32)
    t = tds.DistributedFlatIndex(tmesh(8), vecs, quantization=Quantization.BQ)
    j = jds.DistributedFlatIndex(jmesh(), vecs, quantization=JQuant.BQ)
    np.testing.assert_array_equal(flat_index_to_arrays(t)["codes"].view(np.uint32),
                                  np.asarray(j.codes))
    got = t.search(qs, K)
    _same(got, j.search(qs, K), ties=True)
    h = ((qs > 0)[:, None, :] != (vecs > 0)[None, :, :]).sum(-1)
    np.testing.assert_array_equal(np.sort(h[np.arange(6)[:, None], got[1]], axis=1),
                                  np.sort(h, axis=1)[:, :K])
    _identical(got, tds.DistributedFlatIndex("cpu", vecs, quantization=Quantization.BQ)
               .search(qs, K))


def test_bq_sharded_rerank(rng):
    """BQ + a bf16 rerank per shard (n so that every shard is mostly
    padding): serving recall on a cluster mixture, with and without the
    shard split, and the reference's recall."""
    n, d, nc = 6000, 128, 64
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, nc, n)]
            + 0.25 * rng.standard_normal((n, d))).astype(np.float32)
    qs = (vecs[rng.integers(0, n, 16)]
          + 0.05 * rng.standard_normal((16, d))).astype(np.float32)
    truth = np.argsort(-(qs @ vecs.T) / np.linalg.norm(vecs, axis=1), axis=1)[:, :K]
    t = tds.DistributedFlatIndex(tmesh(8), vecs, quantization=Quantization.BQ,
                                 rerank_dtype=torch.bfloat16)
    j = jds.DistributedFlatIndex(jmesh(), vecs, quantization=JQuant.BQ,
                                 rerank_dtype=jnp.bfloat16)
    scores, ids = t.search(qs, K, oversample=16)
    js, ji = j.search(qs, K, oversample=16)
    assert compute_recall(ids, truth) >= 0.9
    assert compute_recall(ids, truth) >= compute_recall(ji, truth) - 0.02
    assert ((ids >= 0) & (ids < n)).all()
    assert (scores[:, :-1] >= scores[:, 1:] - 1e-4).all()
    # a query whose per-shard shortlists cover their rows matches exactly
    full = t.search(qs, K, oversample=n // K)
    _same(full, j.search(qs, K, oversample=n // K))


# -- PQ ----------------------------------------------------------------------------------

def test_sharded_pq_matches_reference_and_one_device(data):
    """ADC per shard with the codebook replicated: the reference's codes,
    ids and scores on its trained codebook; the one-device result."""
    vecs, qs = data
    j = jds.DistributedPQIndex(jmesh(), vecs, metric=JMetric.COSINE, m=8,
                               train_sample=2048)
    jcb = dict(centroids=np.asarray(j.codebook.centroids), rotation=None, coarse=None)
    cb = pq_codebook_from_arrays(**jcb, device="cpu")
    t = tds.DistributedPQIndex(tmesh(8), vecs, codebook=cb)
    np.testing.assert_array_equal(t.codes.cpu().numpy(), np.asarray(j.codes))
    got = t.search(qs, K)
    _same(got, j.search(qs, K), ties=True)
    _identical(got, tds.DistributedPQIndex("cpu", vecs, codebook=cb).search(qs, K))
    carried = pq_index_from_arrays(
        metric=Metric.COSINE, codes=np.asarray(j.codes), sqnorm=np.asarray(j.sqnorm),
        valid=np.asarray(j.valid), codebook=jcb, device=tmesh(4))
    _identical(carried.search(qs, K), got)


def test_pq_cache_rerank_is_shard_local(rng):
    """The PQ-cache serving shape (``pq_rerank``): each shard's f8-cache
    shortlist reranked against the exact reconstruction of its own code
    rows, then the merge; the same with the code table on the host, each
    shard's rows gathered there. Held to the reference's sharded body."""
    from coltt_tpu.store.flat import FlatStore as JFlatStore

    n, d = 4096, 64
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((8, d)).astype(np.float16).astype(np.float32)
    js = JFlatStore(d, quantization=JQuant.PQ, pq_subspaces=8, pq_centroids=64,
                    pq_train_iters=4)
    js.upsert_many([str(i) for i in range(n)], vecs)
    js.sync()
    cb = js.codebook
    jm = jmesh(8)
    put = lambda a: jax.device_put(a, shard_spec(jm))  # noqa: E731
    jout = jds.sharded_scan_topk(
        jm, put(js.codes), put(js.scale), put(js.sqnorm), put(js.valid),
        jax.device_put(jnp.asarray(qs), batch_spec(jm)), k=K, metric=JMetric.COSINE,
        compute_dtype=jnp.bfloat16, oversample=4,
        pq_rerank=(put(js.pqcodes), cb.centroids, cb.coarse))
    jout = tuple(np.asarray(x) for x in jout)
    mesh = tmesh(8)
    cache = _from_bits(np.asarray(js.codes), torch.float8_e4m3fn)
    args = [cache, torch.from_numpy(np.array(js.scale)),
            torch.from_numpy(np.array(js.sqnorm)), torch.from_numpy(np.array(js.valid))]
    cents = torch.from_numpy(np.array(cb.centroids))
    pqc = np.array(js.pqcodes)
    for table in (torch.from_numpy(pqc), pqc):   # device codes, host codes
        for where in (mesh, "cpu"):
            got = tds.sharded_scan_topk(
                where, *args, torch.from_numpy(qs), k=K, metric=Metric.COSINE,
                compute_dtype=torch.bfloat16, oversample=4,
                pq_rerank=(table, cents, None))
            _same(tuple(x.numpy() for x in got), jout, ties=True)


# -- CFLAT -------------------------------------------------------------------------------

def test_sharded_cflat_matches_reference(rng):
    """The weighted two-field scan per shard and the merge: the
    reference's sharded result on the same rows (f32), and the port's
    one-device result."""
    n, d1, d2 = 1024, 32, 16
    v1 = rng.standard_normal((n, d1)).astype(np.float32)
    v2 = rng.standard_normal((n, d2)).astype(np.float32)
    q1 = rng.standard_normal((3, d1)).astype(np.float32)
    q2 = rng.standard_normal((3, d2)).astype(np.float32)
    jm = jmesh()
    fields = []
    for v in (v1, v2):
        sq = (v * v).sum(1)
        fields.append((v, np.ones((n, 1), np.float32), sq))
    valid = np.ones(n, bool)
    valid[::7] = False
    jstate = tuple(tuple(jax.device_put(jnp.asarray(a), shard_spec(jm)) for a in f)
                   for f in fields)
    jv, ji = jds.sharded_cflat_topk(
        jm, jstate, jax.device_put(jnp.asarray(valid), shard_spec(jm)),
        (jax.device_put(jnp.asarray(q1), batch_spec(jm)),
         jax.device_put(jnp.asarray(q2), batch_spec(jm))),
        (jnp.float32(0.6), jnp.float32(0.4)), k=K, metric=JMetric.COSINE,
        compute_dtype=jnp.float32)
    tstate = tuple(tuple(torch.from_numpy(a) for a in f) for f in fields)
    kw = dict(k=K, metric=Metric.COSINE, compute_dtype=torch.float32)
    args = (tstate, torch.from_numpy(valid), (torch.from_numpy(q1), torch.from_numpy(q2)),
            (0.6, 0.4))
    tv, ti = tds.sharded_cflat_topk(tmesh(8), *args, **kw)
    assert ti.dtype == torch.int32
    _same((tv.numpy(), ti.numpy()), (np.asarray(jv), np.asarray(ji)))
    _identical(tuple(x.numpy() for x in tds.sharded_cflat_topk("cpu", *args, **kw)),
               (tv.numpy(), ti.numpy()))
    bv, bi = tds.sharded_cflat_topk(tmesh(4, batch=2), *args, **kw)
    _identical((bv.numpy(), bi.numpy()), (tv.numpy(), ti.numpy()))


# -- carrying state across -----------------------------------------------------------------

def test_index_state_carries_both_ways(data):
    """A JAX index sharded over 4 devices and the port's over a 4-shard
    mesh hold the same arrays; carried as numpy into the port, over 4
    shards or one device, and back out, they search alike."""
    vecs, qs = data
    j = jds.DistributedFlatIndex(jmesh(4), vecs, quantization=JQuant.I8,
                                 rerank_dtype=jnp.bfloat16)
    t = tds.DistributedFlatIndex(tmesh(4), vecs, quantization=Quantization.I8,
                                 rerank_dtype=torch.bfloat16)
    arrays, jarr = flat_index_to_arrays(t), _jax_arrays(j)
    for key in ("codes", "valid", "scale"):
        np.testing.assert_array_equal(arrays[key], jarr[key].view(arrays[key].dtype))
    # the norms to f32 rounding: their sums over D run in another order
    np.testing.assert_allclose(arrays["sqnorm"], jarr["sqnorm"], rtol=1e-6)
    np.testing.assert_array_equal(arrays["rr_codes"], jarr["rr_codes"].view(np.int16))
    want = j.search(qs, K, oversample=4)
    for where in (tmesh(4), "cpu", tmesh(2, batch=2)):
        got = flat_index_from_arrays(**arrays, device=where).search(qs, K, oversample=4)
        _same(got, want)


# -- the multi-process helpers, in one process --------------------------------------------

def test_multihost_single_process(data):
    """One process: init is a no-op, the host-major mesh is the local
    mesh, the host owns every row, assembly is a placement, and the
    search equals the exact scan and the reference's."""
    from coltt_tpu_torch.parallel.multihost import (
        assemble_global_rows, host_row_range, init_distributed, make_multihost_mesh,
    )

    vecs, qs = data
    assert init_distributed() == 1
    mesh = make_multihost_mesh(devices=["cpu"] * 8)
    assert mesh.shape[SHARD_AXIS] == 8 and mesh.shape["batch"] == 1
    assert not mesh.distributed
    assert host_row_range(4096, mesh) == (0, 4096)
    codes = assemble_global_rows(mesh, vecs, 4096)
    assert codes.shape == (4096, 64)
    sqn = assemble_global_rows(mesh, (vecs * vecs).sum(1), 4096)
    valid = assemble_global_rows(mesh, np.ones(4096, bool), 4096)
    s, i = tds.sharded_scan_topk(mesh, codes, None, sqn, valid, torch.from_numpy(qs),
                                 k=5, compute_dtype=torch.float32)
    exact = np.argsort(-(qs @ vecs.T) / np.linalg.norm(vecs, axis=1), axis=1)[:, :5]
    np.testing.assert_array_equal(i.numpy(), exact)
    jm = jmesh()
    js = jds.sharded_scan_topk(jm, jnp.asarray(vecs), None, jnp.asarray((vecs * vecs).sum(1)),
                               jnp.ones(4096, bool), jnp.asarray(qs), k=5,
                               compute_dtype=jnp.float32)
    _same((s.numpy(), i.numpy()), tuple(np.asarray(x) for x in js))


def test_multihost_mesh_batch_axis_and_rejections(data):
    from coltt_tpu_torch.parallel.multihost import (
        assemble_global_rows, host_row_range, make_multihost_mesh,
    )

    vecs, _ = data
    mesh = make_multihost_mesh(batch=2, devices=["cpu"] * 8)
    assert mesh.shape[SHARD_AXIS] == 4 and mesh.shape["batch"] == 2
    with pytest.raises(ValueError):
        make_multihost_mesh(batch=3, devices=["cpu"] * 8)
    mesh = make_multihost_mesh(devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        host_row_range(100, mesh)  # not divisible by 8
    with pytest.raises(ValueError):
        assemble_global_rows(mesh, vecs[:100], 4096)


@pytest.mark.parametrize("per_process,want", [
    ([["cpu"] * 4, ["cpu"] * 4], "gloo"),          # CPU meshes
    ([["cuda:A"] * 2, ["cuda:A"] * 2], "gloo"),    # two processes share a card
    ([["cuda:A"], ["cuda:B"]], "nccl"),            # a card each
    ([["cuda:A", "cuda:B"], ["cuda:C", "cuda:D"]], "nccl"),
    ([["cuda:A", "cuda:B"], ["cuda:B", "cuda:C"]], "gloo"),
    ([["cuda:A"]], "nccl"),                        # one process on a card
    ([["cuda:A", "cpu"]], "gloo"),
], ids=["cpu", "shared-card", "card-each", "cards-each", "overlap", "one", "mixed"])
def test_choose_backend(per_process, want):
    """The backend rule over every process's devices (named by
    ``device_keys``: a card's UUID, so the same card compares equal under
    any ``CUDA_VISIBLE_DEVICES``)."""
    from coltt_tpu_torch.parallel.multihost import choose_backend, device_keys

    assert choose_backend(per_process) == want
    assert device_keys(["cpu", torch.device("cpu")]) == ["cpu", "cpu"]


# -- on the card: K1 and K2 once per shard (needs a card) ---------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 are CUDA kernels with no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("unit_i8", [False, True], ids=["k1", "k2"])
def test_sharded_kernels_on_the_card(rng, cuda_device, unit_i8):
    """Four shards of one card: K1 (K2) launches once per shard and query
    block; K1's merged keys give the one-device kernel's ids over the
    same rows (the 4-shard layout's, so the bins are the same); K2's
    reranked result recalls >= 0.9 of the exact scan; a queued sharded
    search never waits for the device."""
    from coltt_tpu_torch import bench
    from coltt_tpu_torch.ops import fused_scan as fs

    n, d = 32768, 128
    rows = rng.standard_normal((n, d)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32)).to(cuda_device)
    mesh = make_mesh(4, devices=[cuda_device] * 4)
    idx = bench.build_index(rows, mesh, unit_i8=unit_i8)
    kw = dict(oversample=4, fused=True, final="approx")
    idx.search_tensors(q, K, **kw)  # builds and loads the kernels
    counter = fs.binmax_scan_i8 if unit_i8 else fs.binmax_scan
    before = counter.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scores, ids = idx.search_tensors(q, K, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert counter.launches - before == 4
    assert torch.isfinite(scores).all() and ((ids >= 0) & (ids < n)).all()
    exact = tds.DistributedFlatIndex("cpu", rows).search(q.cpu().numpy(), K)[1]
    assert compute_recall(ids.cpu().numpy(), exact) >= 0.9
    if unit_i8:
        return
    arrays = (idx.codes, idx.scale, idx.sqnorm, idx.valid)
    raw = dict(k=K, metric=Metric.COSINE, compute_dtype=torch.bfloat16, fused=True,
               final="approx")
    got = tds.sharded_scan_topk(mesh, *arrays, q, **raw)
    flat = [torch.cat(a.host_blocks()) for a in arrays]
    want = tds.sharded_scan_topk(cuda_device, *flat, q, **raw)
    _same(tuple(x.cpu().numpy() for x in got), tuple(x.cpu().numpy() for x in want),
          atol=0.0, rtol=0.0, ties=True)

"""The rerank, the flat index and the bench's search of the port vs the
JAX package.

Inputs are made with numpy and handed to both packages; the JAX index
runs on a one-device mesh, its Pallas kernels interpreted, as
``tests/test_parallel.py`` runs it.

Tolerances, stated once:

- rerank / rescore: ids equal (id sets where distances tie); negated
  distances within 1e-5 absolute for cosine, and within 1e-5 relative for
  euclidean, whose squared distances reach ~2*D and carry f32 rounding
  of that size: the f32 sums over D run in another order.
- the index on state carried across (``flat_index_from_arrays``): ids
  equal, up to the order of near-tied rows (the rerank's f32 sums differ
  in the last bits); scores within 1e-3 on the 0-100 scale (1e-5 of a
  cosine distance, times 50).
- the index on each package's own ingest: recall@10 against the f32
  exact scan >= 0.9, as ``tests/test_parallel.py`` asks of the reference;
  ids and scores against the reference's as on carried state. The codes
  are bit-identical, except unit-i8's: its global scale within 1e-6
  relative, and its codes within 1 on at most 1e-5 of the entries (the
  row norms are summed in another order, which moves a few values across
  a rounding edge: 1 of 1,048,576 at this seed, scale 1.4e-7 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coltt_tpu.ops import bq as jbq
from coltt_tpu.ops import topk as jtopk
from coltt_tpu.ops.distance import Metric as JMetric
from coltt_tpu.ops.quant import Quantization as JQuant
from coltt_tpu.parallel import dist_search as jds
from coltt_tpu.parallel.mesh import make_mesh
from coltt_tpu_torch import bench, bench_frontier
from coltt_tpu_torch.ops import fused_scan as fs
from coltt_tpu_torch.ops import topk as ttopk
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.parallel import dist_search as tds
from coltt_tpu_torch.parallel.convert import (
    flat_index_from_arrays,
    flat_index_to_arrays,
    pq_codebook_from_arrays,
    pq_index_from_arrays,
    pq_index_to_arrays,
)

torch.set_num_threads(2)

N, D, K = 8192, 128, 10


def _jmesh():
    return make_mesh(num_shards=1, batch=1)


def _same_ids(ti, ji, tn, jn):
    """Equal rows, or equal id sets among rows whose values agree."""
    for r in range(ji.shape[0]):
        if not np.array_equal(ti[r], ji[r]):
            np.testing.assert_array_equal(np.sort(ti[r]), np.sort(ji[r]))
            np.testing.assert_allclose(np.sort(tn[r]), np.sort(jn[r]), atol=1e-3)


# -- rerank --------------------------------------------------------------------

@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN],
                         ids=lambda m: m.name)
def test_rerank_matches_jax(rng, metric):
    n, q, c = 4096, 6, 40
    rows = rng.standard_normal((n, D)).astype(np.float32)
    queries = rng.standard_normal((q, D)).astype(np.float32)
    ids = np.stack([rng.choice(n, c, replace=False) for _ in range(q)]).astype(np.int32)
    negd = -rng.uniform(0, 1, (q, c)).astype(np.float32)
    negd[:, 3] = -np.inf   # a tombstone that won a bin
    negd[1, :] = -np.inf   # a query with nothing valid
    ids[2, 7] = -1         # an empty slot
    negd[2, 7] = -np.inf
    rr = jnp.asarray(rows).astype(jnp.bfloat16)
    jn, ji = jtopk.rerank_neg_topk(jnp.asarray(queries), jnp.asarray(negd),
                                   jnp.asarray(ids), rr, None, k=K,
                                   metric=int(metric))
    jn, ji = np.asarray(jn), np.asarray(ji)
    tn, ti = ttopk.rerank_neg_topk(
        torch.from_numpy(queries), torch.from_numpy(negd), torch.from_numpy(ids),
        torch.from_numpy(rows).to(torch.bfloat16), k=K, metric=metric)
    tn, ti = tn.numpy(), ti.numpy()
    finite = np.isfinite(jn)
    np.testing.assert_array_equal(np.isfinite(tn), finite)
    if metric == Metric.COSINE:
        np.testing.assert_allclose(tn[finite], jn[finite], rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(tn[finite], jn[finite], rtol=1e-5, atol=0)
    assert not finite[1].any()
    # ids equal where the distances are finite; the -inf tails are ties,
    # any of the shortlist's masked ids
    for r in range(q):
        np.testing.assert_array_equal(ti[r][finite[r]], ji[r][finite[r]])
        assert set(ti[r][~finite[r]].tolist()) <= set(ids[r][~np.isfinite(negd[r])])


def test_rescore_rounds_operands_not_dots(rng):
    """bf16 operands, f32 products and sums: the port's dot equals the
    float64 dot of the bf16-rounded operands to f32 precision (a bf16
    product would miss it by ~1e-3)."""
    q = rng.standard_normal((2, D)).astype(np.float32)
    cand = rng.standard_normal((2, 5, D)).astype(np.float32)
    negd = np.zeros((2, 5), np.float32)
    ids = np.arange(10, dtype=np.int32).reshape(2, 5)
    tn, ti = ttopk.rescore_topk(torch.from_numpy(q), torch.from_numpy(cand),
                                torch.from_numpy(negd), torch.from_numpy(ids),
                                k=5, metric=Metric.EUCLIDEAN)
    qb = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    cb = torch.from_numpy(cand).to(torch.bfloat16).double().numpy()
    want = (q.astype(np.float64) ** 2).sum(1)[:, None] + (cb * cb).sum(2) \
        - 2.0 * np.einsum("qd,qcd->qc", qb, cb)
    got = -np.take_along_axis(tn.numpy(), np.argsort(ti.numpy() % 5), axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- the index -------------------------------------------------------------------

_CONFIGS = {
    # name: (JAX kwargs, port kwargs, search kwargs)
    "i8-approx": (dict(quantization=JQuant.I8, rerank_dtype=jnp.bfloat16),
                  dict(quantization=Quantization.I8, rerank_dtype=torch.bfloat16),
                  dict(fused=True, oversample=4, final="approx")),
    "i8-slot2": (dict(quantization=JQuant.I8, rerank_dtype=jnp.bfloat16),
                 dict(quantization=Quantization.I8, rerank_dtype=torch.bfloat16),
                 dict(fused=True, oversample=4, final="slot2")),
    "i8-approx2": (dict(quantization=JQuant.I8, rerank_dtype=jnp.bfloat16),
                   dict(quantization=Quantization.I8, rerank_dtype=torch.bfloat16),
                   dict(fused=True, oversample=4, final="approx2")),
    "i8-slot2t": (dict(quantization=JQuant.I8, rerank_dtype=jnp.bfloat16),
                  dict(quantization=Quantization.I8, rerank_dtype=torch.bfloat16),
                  dict(fused=True, oversample=4, final="slot2t")),
    "unit-i8": (dict(quantization=JQuant.I8, rerank_dtype=jnp.bfloat16, unit_i8=True),
                dict(quantization=Quantization.I8, rerank_dtype=torch.bfloat16,
                     unit_i8=True),
                dict(oversample=4)),
    "none": (dict(quantization=JQuant.NONE), dict(quantization=Quantization.NONE),
             dict()),
    # K1's float-code loops: bf16 operands (f8 codes with a bf16 rerank,
    # bf16 codes) and exact f32 (NONE)
    "f8-approx": (dict(quantization=JQuant.F8, rerank_dtype=jnp.bfloat16),
                  dict(quantization=Quantization.F8, rerank_dtype=torch.bfloat16),
                  dict(fused=True, oversample=4, final="approx")),
    "bf16-approx": (dict(quantization=JQuant.BF16), dict(quantization=Quantization.BF16),
                    dict(fused=True, oversample=4, final="approx")),
    "none-fused": (dict(quantization=JQuant.NONE), dict(quantization=Quantization.NONE),
                   dict(fused=True, oversample=4, final="approx")),
}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((N - 1000, D)).astype(np.float32)  # pads to N
    queries = rng.standard_normal((16, D)).astype(np.float32)
    gt = jds.DistributedFlatIndex(_jmesh(), rows, metric=JMetric.COSINE,
                                  quantization=JQuant.NONE)
    return rows, queries, gt.search(queries, K)[1]


def _jax_arrays(idx):
    """A JAX index's state as numpy, for flat_index_from_arrays."""
    host = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return dict(
        dim=idx.dim, metric=int(idx.metric), quantization=int(idx.quantization),
        n=idx.n, codes=host(idx.codes), valid=host(idx.valid),
        scale=host(idx.scale), sqnorm=host(idx.sqnorm), rr_codes=host(idx.rr_codes),
        gscale=host(getattr(idx, "gscale", None)) if idx.unit_i8 else None,
        bin_live=host(idx.bin_live) if idx.unit_i8 else None,
    )


@pytest.mark.parametrize("config", list(_CONFIGS))
def test_index_matches_jax(corpus, config):
    rows, queries, truth = corpus
    jkw, tkw, skw = _CONFIGS[config]
    j_idx = jds.DistributedFlatIndex(_jmesh(), rows, metric=JMetric.COSINE, **jkw)
    t_idx = tds.DistributedFlatIndex("cpu", rows, metric=Metric.COSINE, **tkw)
    assert t_idx.codes.shape[0] == j_idx.codes.shape[0] == N
    assert not t_idx.valid[len(rows):].any()
    js, ji = j_idx.search(queries, K, **skw)
    ts, ti = t_idx.search(queries, K, **skw)
    for ids in (ji, ti):
        assert ttopk.compute_recall(ids, truth) >= 0.9
        assert ((ids >= 0) & (ids < len(rows))).all()
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-3)
    _same_ids(ti, ji, ts, js)
    arrays = _jax_arrays(j_idx)
    codes = flat_index_to_arrays(t_idx)["codes"]
    if config == "unit-i8":
        np.testing.assert_allclose(float(t_idx.gscale), arrays["gscale"], rtol=1e-6)
        diff = np.abs(codes.astype(np.int32) - arrays["codes"].astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-5, (diff > 0).sum()
    else:
        np.testing.assert_array_equal(codes, arrays["codes"].view(codes.dtype))

    # the JAX index's own state, searched by the port
    carried = flat_index_from_arrays(
        **arrays, rerank_dtype=tkw.get("rerank_dtype"), device="cpu")
    cs, ci = carried.search(queries, K, **skw)
    np.testing.assert_allclose(cs, js, rtol=0, atol=1e-3)
    _same_ids(ci, ji, cs, js)
    back = flat_index_from_arrays(**flat_index_to_arrays(carried), device="cpu")
    bs, bi = back.search(queries, K, **skw)
    np.testing.assert_array_equal(bi, ci)
    np.testing.assert_array_equal(bs, cs)


def test_index_scores_descend_and_k1_or_k2_selected(corpus):
    """Fused searches run K1 (CPU: its plain version) and unit-i8 runs K2;
    scores come back descending on the 0-100 scale."""
    rows, queries, _ = corpus
    idx = tds.DistributedFlatIndex("cpu", rows, quantization=Quantization.I8,
                                   rerank_dtype=torch.bfloat16, unit_i8=True)
    scores, ids = idx.search(queries, K, oversample=4)
    assert (scores[:, :-1] >= scores[:, 1:] - 1e-4).all()
    assert ((scores > 0) & (scores <= 100)).all()
    np.testing.assert_array_equal(idx.bin_live.numpy(), fs.unit_i8_bin_live(
        idx.valid, fs.chunk_for(N)).numpy())


def test_unit_i8_never_returns_padding_rows(rng):
    """When every valid row scores a negative cosine, zero-code padding
    rows (dot exactly 0) win their bins: the valid-row mask before the
    rerank keeps them out (tests/test_parallel.py, ported)."""
    n, d, k = 1000, 128, 5  # pads to 4096: mostly padding rows
    base = np.abs(rng.standard_normal((n, d))).astype(np.float32)
    q = -np.abs(rng.standard_normal((2, d))).astype(np.float32)
    idx = tds.DistributedFlatIndex("cpu", base, metric=Metric.COSINE,
                                   quantization=Quantization.I8,
                                   rerank_dtype=torch.bfloat16, unit_i8=True)
    scores, ids = idx.search(q, k)
    finite = np.isfinite(scores)
    assert ((ids >= 0) & (ids < n))[finite].all(), ids
    assert (ids[~finite] == -1).all()
    s2, i2 = idx.search(base[3:4], k)
    assert i2[0, 0] == 3 and np.isfinite(s2[0, 0])
    # the reference agrees on the same rows
    j_idx = jds.DistributedFlatIndex(_jmesh(), base, metric=JMetric.COSINE,
                                     quantization=JQuant.I8,
                                     rerank_dtype=jnp.bfloat16, unit_i8=True)
    js, ji = j_idx.search(q, k)
    np.testing.assert_array_equal(np.isfinite(js), finite)


def test_unit_i8_requires_cosine_and_rerank(rng):
    vecs = rng.standard_normal((1024, 256)).astype(np.float32)
    with pytest.raises(ValueError):
        tds.DistributedFlatIndex("cpu", vecs, metric=Metric.EUCLIDEAN,
                                 quantization=Quantization.I8,
                                 rerank_dtype=torch.bfloat16, unit_i8=True)
    with pytest.raises(ValueError):
        tds.DistributedFlatIndex("cpu", vecs, metric=Metric.COSINE,
                                 quantization=Quantization.I8, unit_i8=True)


def test_unported_paths_name_the_roadmap(rng):
    """The paths that were still to port (several devices) now serve: the
    flat and PQ indexes and CFLAT over a two-shard CPU mesh give the
    one-device results (tests/test_torch_parallel.py holds them against
    the reference)."""
    from coltt_tpu_torch.parallel.mesh import make_mesh as tmesh

    vecs = rng.standard_normal((64, 128)).astype(np.float32)
    mesh = tmesh(2, devices=["cpu", "cpu"])
    one, two = (tds.DistributedFlatIndex(d, vecs) for d in ("cpu", mesh))
    assert two.codes.shape[0] == 2 * 4096 and two.codes.local_n == 4096
    for got, want in zip(two.search(vecs[:5], 4), one.search(vecs[:5], 4)):
        np.testing.assert_array_equal(got, want)
    pq_one = tds.DistributedPQIndex("cpu", vecs, m=16, train_sample=64)
    pq_two = tds.DistributedPQIndex(mesh, vecs, codebook=pq_one.codebook)
    for got, want in zip(pq_two.search(vecs[:5], 4), pq_one.search(vecs[:5], 4)):
        np.testing.assert_array_equal(got, want)
    codes = torch.from_numpy(vecs)
    sqn = (codes * codes).sum(dim=1)
    valid = torch.ones(64, dtype=torch.bool)
    state = ((codes, None, sqn), (codes, None, sqn))
    for where in ("cpu", mesh):
        scores, ids = tds.sharded_cflat_topk(where, state, valid, (codes[:3], codes[:3]),
                                             (0.5, 0.5), k=4, compute_dtype=torch.float32)
        assert ids[:, 0].tolist() == [0, 1, 2]
        np.testing.assert_allclose(scores[:, 0].numpy(), 100.0, rtol=1e-6)
    with pytest.raises(ValueError, match="cosine-only"):
        tds.DistributedFlatIndex("cpu", vecs, metric=Metric.EUCLIDEAN,
                                 quantization=Quantization.BQ)


# -- BQ and PQ indexes ----------------------------------------------------------------

@pytest.fixture(scope="module")
def clustered():
    """A cluster mixture (sign codes rank noise on i.i.d. rows) and its
    exact cosine top-10."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((64, D)).astype(np.float32)
    rows = (centers[rng.integers(0, 64, N - 1000)]
            + 0.35 * rng.standard_normal((N - 1000, D))).astype(np.float32)
    queries = (centers[rng.integers(0, 64, 16)]
               + 0.35 * rng.standard_normal((16, D))).astype(np.float32)
    gt = jds.DistributedFlatIndex(_jmesh(), rows, metric=JMetric.COSINE,
                                  quantization=JQuant.NONE)
    return rows, queries, gt.search(queries, K)[1]


@pytest.mark.parametrize("rerank", [True, False], ids=["bf16-rerank", "no-rerank"])
def test_bq_index_matches_jax(clustered, rerank):
    """Both constructors (vectors and pre-packed words) against the
    reference's on a one-device mesh: words bit-identical, same ids and
    scores (the Hamming ties rank the lower id first in both)."""
    rows, queries, truth = clustered
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if rerank else (None, None)
    j_idx = jds.DistributedFlatIndex(_jmesh(), rows, quantization=JQuant.BQ,
                                     rerank_dtype=jdt)
    t_idx = tds.DistributedFlatIndex("cpu", rows, quantization=Quantization.BQ,
                                     rerank_dtype=tdt)
    packed = np.asarray(jbq.bq_encode(jnp.asarray(rows)))
    j_pk = jds.DistributedFlatIndex.from_bq_codes(
        _jmesh(), packed, dim=D, rr_codes=rows if rerank else None)
    t_pk = tds.DistributedFlatIndex.from_bq_codes(
        "cpu", packed, dim=D, rr_codes=rows if rerank else None)
    for t in (t_idx, t_pk):
        assert t.codes.shape == (N, D // 32) and not t.valid[len(rows):].any()
        np.testing.assert_array_equal(t.codes.numpy().view(np.uint32),
                                      np.asarray(j_idx.codes))
    js, ji = j_idx.search(queries, K, oversample=16)
    for j, t in ((j_idx, t_idx), (j_pk, t_pk)):
        ts, ti = t.search(queries, K, oversample=16)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-3)
        _same_ids(ti, ji, ts, js)
        np.testing.assert_array_equal(j.search(queries, K, oversample=16)[1], ji)
    if rerank:
        assert ttopk.compute_recall(ti, truth) >= 0.9
    # the reference's state, carried across
    arrays = _jax_arrays(j_idx)
    carried = flat_index_from_arrays(**arrays, rerank_dtype=tdt, device="cpu")
    cs, ci = carried.search(queries, K, oversample=16)
    _same_ids(ci, ji, cs, js)
    np.testing.assert_array_equal(flat_index_to_arrays(carried)["codes"].view(np.uint32),
                                  arrays["codes"])


def test_pq_index_matches_jax(clustered):
    """DistributedPQIndex on the reference's codebook: codes equal up to
    near-ties (tests/test_torch_pq.py's rule), and on the reference's own
    codes the same ids and scores."""
    rows, queries, truth = clustered
    j_idx = jds.DistributedPQIndex(_jmesh(), rows, m=16, train_sample=4096,
                                   opq_iters=2)
    cb = j_idx.codebook
    arrays = {"centroids": np.asarray(cb.centroids), "rotation": np.asarray(cb.rotation),
              "coarse": None}
    t_idx = tds.DistributedPQIndex("cpu", rows,
                                   codebook=pq_codebook_from_arrays(**arrays, device="cpu"))
    jcodes = np.asarray(j_idx.codes)
    assert (t_idx.codes.numpy() == jcodes).all(axis=1).mean() >= 0.999
    js, ji = j_idx.search(queries, K)
    carried = pq_index_from_arrays(metric=Metric.COSINE, codes=jcodes,
                                   sqnorm=np.asarray(j_idx.sqnorm),
                                   valid=np.asarray(j_idx.valid), codebook=arrays,
                                   device="cpu")
    cs, ci = carried.search(queries, K)
    np.testing.assert_allclose(cs, js, rtol=0, atol=1e-3)
    _same_ids(ci, ji, cs, js)
    back = pq_index_from_arrays(**pq_index_to_arrays(carried), device="cpu")
    np.testing.assert_array_equal(back.search(queries, K)[1], ci)
    ts, ti = t_idx.search(queries, K)
    assert ttopk.compute_recall(ti, ji) >= 0.9


def test_pq_cache_rerank_branch_matches_jax(clustered):
    """sharded_scan_topk's PQ-cache branch: the f8 reconstruction cache's
    shortlist (plain or K1), reranked against the exact reconstruction."""
    from coltt_tpu.store.flat import FlatStore as JFlatStore

    rows, queries, _ = clustered
    js = JFlatStore(D, quantization=JQuant.PQ, pq_subspaces=16, pq_centroids=64,
                    pq_train_iters=5, pq_opq_iters=2)
    js.upsert_many([str(i) for i in range(len(rows))], rows)
    js.sync()
    cb = js.codebook
    jq = np.asarray(jnp.asarray(queries) @ cb.rotation)
    tcb = pq_codebook_from_arrays(np.asarray(cb.centroids), np.asarray(cb.rotation),
                                  device="cpu")
    host = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    codes = torch.from_numpy(np.array(js.codes).view(np.int8)).view(torch.float8_e4m3fn)
    for fused in (False, True):
        kw = dict(k=K, oversample=4, fused=fused)
        js_, ji = map(np.asarray, jds.sharded_scan_topk(
            _jmesh(), js.codes, js.scale, js.sqnorm, js.valid, jnp.asarray(jq),
            pq_rerank=(js.pqcodes, cb.centroids, None), **kw))
        ts, ti = tds.sharded_scan_topk(
            "cpu", codes, host(js.scale), host(js.sqnorm), host(js.valid), host(jq),
            pq_rerank=(host(js.pqcodes), tcb.centroids, None), **kw)
        np.testing.assert_allclose(ts.numpy(), js_, rtol=0, atol=1e-3)
        _same_ids(ti.numpy(), ji, ts.numpy(), js_)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tds.sharded_scan_topk("cpu", codes, None, None, None, host(jq), k=K,
                              rr_codes=codes, pq_rerank=(None, None, None))


def test_euclidean_index_matches_jax(rng):
    """The euclidean metric through the fused scan and the rerank."""
    rows = rng.standard_normal((4096, D)).astype(np.float32)
    queries = rng.standard_normal((5, D)).astype(np.float32)
    j_idx = jds.DistributedFlatIndex(_jmesh(), rows, metric=JMetric.EUCLIDEAN,
                                     quantization=JQuant.F8,
                                     rerank_dtype=jnp.bfloat16)
    carried = flat_index_from_arrays(**_jax_arrays(j_idx),
                                     rerank_dtype=torch.bfloat16, device="cpu")
    js, ji = j_idx.search(queries, K, fused=True, oversample=4, final="exact")
    cs, ci = carried.search(queries, K, fused=True, oversample=4, final="exact")
    np.testing.assert_allclose(cs, js, rtol=1e-5, atol=1e-4)
    _same_ids(ci, ji, cs, js)


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 are CUDA kernels with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("unit_i8", [False, True], ids=["k1", "k2"])
def test_queued_search_never_syncs(rng, cuda_device, unit_i8):
    """The bench queues searches back to back: nothing on the fused path
    may wait for the device (a synchronous copy would drain the stream)."""
    rows = rng.standard_normal((N, D)).astype(np.float32)
    idx = bench.build_index(rows, cuda_device, unit_i8=unit_i8)
    q = torch.from_numpy(rng.standard_normal((64, D)).astype(np.float32)).to(cuda_device)
    kw = dict(oversample=4, fused=True, final="approx")
    idx.search_tensors(q, K, **kw)  # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scores, ids = idx.search_tensors(q, K, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(scores).all() and ((ids >= 0) & (ids < N)).all()


# -- the bench's search, at a small size -----------------------------------------

@pytest.mark.parametrize("unit_i8", [False, True], ids=["k1", "k2"])
def test_bench_run_small(unit_i8):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((N, D)).astype(np.float32)
    idx = bench.build_index(rows, "cpu", unit_i8=unit_i8)
    gt = tds.DistributedFlatIndex("cpu", rows, quantization=Quantization.NONE)
    rec = bench.run(idx, gt, rng, batch=8, depth=2, warm=1, rounds=2,
                    recall_queries=16)
    assert rec["unit"] == "qps" and rec["value"] > 0
    assert len(rec["qps_rounds"]) == 2 and rec["p50_batch_latency_ms"] > 0
    assert rec["recall_at_10"] >= 0.9 and rec["recall_queries"] == 16
    assert rec["unit_i8"] is unit_i8
    assert rec["final"] == ("auto" if unit_i8 else "approx")


def test_bench_main_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main([]) == 1
    assert capsys.readouterr().out == ""


def test_frontier_run_small(monkeypatch):
    """bench_frontier's measurement on the CPU at a small size (the
    selection's time needs the card and is stubbed): every final reports
    its record; the slot2 aliases give slot2's ids, and approx and approx2
    (aliases of the exact top-k) give exact's and select the same keys."""
    monkeypatch.setattr(bench_frontier, "selection_ms", lambda *a, **kw: 0.0)
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((N, D)).astype(np.float32)
    idx = bench.build_index(rows, "cpu", unit_i8=False)
    gt = tds.DistributedFlatIndex("cpu", rows, quantization=Quantization.NONE)
    q_batches = [torch.from_numpy(rng.standard_normal((8, D), dtype=np.float32))
                 for _ in range(2)]
    queries = rng.standard_normal((16, D), dtype=np.float32)
    records, detail = bench_frontier.frontier(
        idx, q_batches, queries, gt.search(queries, K)[1], warm=1, rounds=2)
    assert tuple(records) == bench_frontier.FINALS
    for final, rec in records.items():
        assert rec["qps"] > 0 and len(rec["qps_rounds"]) == 2, final
        assert rec["recall_at_10"] >= 0.9, final
        assert rec["k1_launches_per_search"] == {}, final  # plain version here
    for final in ("slot2t", "slot2c", "slot2a"):
        np.testing.assert_array_equal(detail[final]["ids"], detail["slot2"]["ids"])
    for final in ("approx", "approx2"):
        np.testing.assert_array_equal(detail[final]["ids"], detail["exact"]["ids"])
        np.testing.assert_array_equal(detail[final]["sel"], detail["exact"]["sel"])
        assert records[final]["ids_equal_to_exact"] == 1.0


def test_bench_frontier_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench_frontier.main([]) == 1
    assert capsys.readouterr().out == ""

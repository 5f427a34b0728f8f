"""Port PQ ops vs the JAX package's on the same numpy inputs.

Training draws from ``jax.random`` in the reference and from a
``torch.Generator`` in the port, so it is held by quality; everything
after training runs on codebooks the reference trained (one per mode,
trained once per module) and carried across as bytes or arrays.

Tolerances, stated once:

- codebook bytes (``CTTPQCB1``): identical both ways;
- ``pq_encode``: codes identical on at least 99.9% of rows; on any other
  row the two chosen centroids are equally near the (rotated, residual)
  subvector within 1e-5 relative (the assignment sums in another order);
  sqnorm within 1e-5 relative;
- ``pq_reconstruct`` within 1e-5 absolute, ``pq_sqnorm`` within 1e-5
  relative;
- ADC scan, rerank and rescore on the reference's codes: negated
  distances within 1e-3 relative; ids identical rank for rank (equal
  distances rank the lower id first in both) except among rows whose
  distances tie to 1e-6, which may trade places;
- training: the port's reconstruction error within 10% of the
  reference's on the same data and settings; OPQ rotations orthonormal to
  1e-4.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coltt_tpu.ops.pq as jpq
import coltt_tpu_torch.ops.pq as tpq
from coltt_tpu.ops.distance import Metric as JMetric
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.topk import compute_recall

torch.set_num_threads(2)

N, D = 4096, 64


def _clustered(rng, n, dim, n_clusters=48, spread=0.15, centers=None):
    if centers is None:
        centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, centers.shape[0], n)
    return (centers[assign] + spread * rng.standard_normal((n, dim))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


_MODES = {
    # name: train_pq keyword arguments of both packages
    "plain": dict(m=8, n_centroids=64, iters=5),
    "opq": dict(m=8, n_centroids=64, iters=5, opq_iters=2),
    "residual": dict(m=8, n_centroids=64, iters=5, opq_iters=2, coarse_centroids=32),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((48, D)).astype(np.float32)
    x = _clustered(rng, N, D, centers=centers)
    q = _clustered(rng, 12, D, centers=centers)
    return x, q


@pytest.fixture(scope="module")
def codebooks(data):
    """Each mode's reference codebook (JAX), its port copy (loaded from
    the reference's bytes) and the reference's codes of the corpus."""
    x, _ = data
    out = {}
    for name, kw in _MODES.items():
        jcb = jpq.train_pq(x, key=jax.random.PRNGKey(1), **kw)
        buf = io.BytesIO()
        jcb.save(buf)
        tcb = tpq.PQCodebook.load(io.BytesIO(buf.getvalue()), device="cpu")
        jcodes, jsq = jpq.pq_encode(x, jcb)
        out[name] = (jcb, tcb, np.asarray(jcodes), np.asarray(jsq), buf.getvalue())
    return out


def _sq(a, b):
    return np.sum((a.astype(np.float64) - b.astype(np.float64)) ** 2)


@pytest.mark.parametrize("mode", list(_MODES))
def test_codebook_bytes_round_trip(data, codebooks, mode):
    jcb, tcb, _, _, jbytes = codebooks[mode]
    out = io.BytesIO()
    tcb.save(out)
    assert out.getvalue() == jbytes
    # a codebook the port trained loads in the reference, byte for byte
    own = tpq.train_pq(data[0], **_MODES[mode])
    tb = io.BytesIO()
    own.save(tb)
    back = jpq.PQCodebook.load(io.BytesIO(tb.getvalue()))
    jb = io.BytesIO()
    back.save(jb)
    assert jb.getvalue() == tb.getvalue()
    assert (back.rotation is None) == (own.rotation is None)
    assert (back.coarse is None) == (own.coarse is None)


@pytest.mark.parametrize("mode", list(_MODES))
def test_encode_matches_up_to_near_ties(data, codebooks, mode):
    x, _ = data
    jcb, tcb, jcodes, jsq, _ = codebooks[mode]
    tcodes, tsq = tpq.pq_encode(_t(x), tcb)
    tcodes = tcodes.numpy()
    assert tcodes.shape == jcodes.shape and tcodes.dtype == np.uint8
    diff = np.nonzero((tcodes != jcodes).any(axis=1))[0]
    assert len(diff) <= 0.001 * N, len(diff)
    cents = np.asarray(jcb.centroids)
    xr = x if jcb.rotation is None else x @ np.asarray(jcb.rotation)
    off = 2 if jcb.coarse is not None else 0
    for r in diff:
        resid = xr[r]
        if jcb.coarse is not None:
            coarse = np.asarray(jcb.coarse)
            cj = int(jcodes[r, 0]) << 8 | int(jcodes[r, 1])
            ct = int(tcodes[r, 0]) << 8 | int(tcodes[r, 1])
            if cj != ct:
                a, b = _sq(resid, coarse[cj]), _sq(resid, coarse[ct])
                assert abs(a - b) <= 1e-5 * max(a, b), (r, a, b)
                continue
            resid = resid - coarse[cj]
        sub = resid.reshape(jcb.m, -1)
        for m in np.nonzero(tcodes[r, off:] != jcodes[r, off:])[0]:
            a = _sq(sub[m], cents[m, jcodes[r, off + m]])
            b = _sq(sub[m], cents[m, tcodes[r, off + m]])
            assert abs(a - b) <= 1e-5 * max(a, b), (r, m, a, b)
    same = np.setdiff1d(np.arange(N), diff)
    np.testing.assert_allclose(tsq.numpy()[same], jsq[same], rtol=1e-5)


@pytest.mark.parametrize("mode", list(_MODES))
def test_reconstruct_and_sqnorm(codebooks, mode):
    jcb, tcb, jcodes, jsq, _ = codebooks[mode]
    for derotate in (False, True):
        want = np.asarray(jpq.pq_reconstruct(jnp.asarray(jcodes), jcb, derotate=derotate))
        got = tpq.pq_reconstruct(_t(jcodes), tcb, derotate=derotate).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tpq.pq_sqnorm(_t(jcodes), tcb).numpy(),
                               np.asarray(jpq.pq_sqnorm(jnp.asarray(jcodes), jcb)),
                               rtol=1e-5)
    np.testing.assert_allclose(tpq.pq_sqnorm(_t(jcodes), tcb).numpy(), jsq, rtol=1e-5)


def _same_ranking(tn, ti, jn, ji):
    """Values within 1e-3 relative; ids identical rank for rank, except
    that rows whose distances tie to 1e-6 (a distance 1 - cos carries f32
    rounding of ~1e-7 of 1, summed in another order) may trade places
    inside their group; the group cut by k may hold other members."""
    np.testing.assert_array_equal(np.isfinite(tn), np.isfinite(jn))
    fin = np.isfinite(jn)
    np.testing.assert_allclose(tn[fin], jn[fin], rtol=1e-3, atol=1e-6)
    for r in range(ji.shape[0]):
        v = jn[r][fin[r]]
        cut = np.nonzero(np.abs(np.diff(v)) > 1e-6 * (1 + np.abs(v[1:])))[0] + 1
        groups = np.split(np.arange(v.size), cut)
        for g in groups[:-1]:
            assert set(ti[r][g]) == set(ji[r][g]), (r, g, ti[r][g], ji[r][g])


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_scan_rerank_rescore_match(data, codebooks, mode, dtype):
    _, q = data
    jcb, tcb, jcodes, jsq, _ = codebooks[mode]
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype]
    valid = np.ones(N, bool)
    valid[::7] = False
    jkw = dict(rotation=jcb.rotation, coarse=jcb.coarse)
    tkw = dict(rotation=tcb.rotation, coarse=tcb.coarse)
    jn, ji = map(np.asarray, jpq.pq_scan_neg_topk(
        jnp.asarray(q), jnp.asarray(jcodes), jcb.centroids, jnp.asarray(jsq),
        jnp.asarray(valid), k=40, compute_dtype=jdt, block_rows=1000, **jkw))
    for block_rows in (1000, None):
        tn, ti = tpq.pq_scan_neg_topk(
            _t(q), _t(jcodes), tcb.centroids, _t(jsq), _t(valid), k=40,
            compute_dtype=tdt, block_rows=block_rows, **tkw)
        _same_ranking(tn.numpy(), ti.numpy(), jn, ji)
    assert valid[ji].all()

    # rerank the reference's shortlist against the exact reconstruction
    rn, ri = map(np.asarray, jpq.pq_rerank_neg_topk(
        jnp.asarray(q), jnp.asarray(jn), jnp.asarray(ji), jnp.asarray(jcodes),
        jcb.centroids, k=10, **jkw))
    un, ui = tpq.pq_rerank_neg_topk(_t(q), _t(jn), _t(ji), _t(jcodes),
                                    tcb.centroids, k=10, **tkw)
    _same_ranking(un.numpy(), ui.numpy(), rn, ri)
    crow = jcodes[ji.reshape(-1)]
    sn, si = tpq.pq_rescore_rows(_t(q), _t(jn), _t(ji), _t(crow), tcb.centroids,
                                 k=10, **tkw)
    _same_ranking(sn.numpy(), si.numpy(), rn, ri)

    # the 0-100 scores of pq_scan_topk
    js, jsi = map(np.asarray, jpq.pq_scan_topk(
        jnp.asarray(q), jnp.asarray(jcodes), jcb, jnp.asarray(jsq),
        jnp.asarray(valid), k=10, compute_dtype=jdt))
    ts, tsi = tpq.pq_scan_topk(_t(q), _t(jcodes), tcb, _t(jsq), _t(valid), k=10,
                               compute_dtype=tdt)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=0.05)
    np.testing.assert_array_equal(tsi.numpy(), jsi)


@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN], ids=lambda m: m.name)
def test_scan_metric_matches(data, codebooks, metric):
    _, q = data
    jcb, tcb, jcodes, jsq, _ = codebooks["opq"]
    jn, ji = map(np.asarray, jpq.pq_scan_neg_topk(
        jnp.asarray(q), jnp.asarray(jcodes), jcb.centroids, jnp.asarray(jsq),
        jnp.ones(N, bool), k=25, metric=JMetric(int(metric)),
        compute_dtype=jnp.float32, rotation=jcb.rotation))
    tn, ti = tpq.pq_scan_neg_topk(
        _t(q), _t(jcodes), tcb.centroids, _t(jsq), None, k=25, metric=metric,
        compute_dtype=torch.float32, rotation=tcb.rotation)
    _same_ranking(tn.numpy(), ti.numpy(), jn, ji)


def _recon_err(x, codebook, encode, reconstruct):
    codes, _ = encode(x, codebook)
    rec = np.asarray(reconstruct(codes, codebook, derotate=True))
    return float(np.mean(np.sum((rec - np.asarray(x)) ** 2, axis=1)))


@pytest.mark.parametrize("mode", list(_MODES))
def test_training_quality_matches_reference(rng, mode):
    """Both packages train on the same anisotropic rows (a per-dim i^-0.5
    spectrum: Lloyd's result there barely depends on its random start,
    while on tight clusters the start moves the error by +-25% in either
    package); the port's reconstruction error is within 10% of the
    reference's."""
    x = (rng.standard_normal((N, D)) * np.arange(1, D + 1) ** -0.5).astype(np.float32)
    jcb = jpq.train_pq(x, key=jax.random.PRNGKey(1), **_MODES[mode])
    want = _recon_err(x, jcb, jpq.pq_encode, jpq.pq_reconstruct)
    own = tpq.train_pq(_t(x), generator=torch.Generator().manual_seed(1),
                       **_MODES[mode])
    got = _recon_err(_t(x), own, tpq.pq_encode,
                     lambda c, cb, derotate: tpq.pq_reconstruct(c, cb, derotate=derotate))
    assert got <= 1.1 * want, (got, want)
    assert own.centroids.shape == (8, 64, 8) and own.code_width == jcb.code_width
    if own.rotation is not None:
        r = own.rotation.numpy()
        np.testing.assert_allclose(r @ r.T, np.eye(D), atol=1e-4)


# -- the reference's property tests (tests/test_pq.py), against the port ----------

def test_train_reduces_reconstruction_error(rng):
    x = _clustered(rng, 4096, 64, n_clusters=32)
    cb = tpq.train_pq(_t(x), m=8, n_centroids=64, iters=10)
    err = _recon_err(_t(x), cb, tpq.pq_encode,
                     lambda c, cb, derotate: tpq.pq_reconstruct(c, cb))
    rand = tpq.PQCodebook(_t(rng.standard_normal((8, 64, 8)).astype(np.float32)))
    err_r = _recon_err(_t(x), rand, tpq.pq_encode,
                       lambda c, cb, derotate: tpq.pq_reconstruct(c, cb))
    assert err < 0.5 * err_r, (err, err_r)


def test_residual_mode_beats_plain_pq(rng):
    x = _t(_clustered(rng, 6144, 64, n_clusters=48))
    plain = tpq.train_pq(x, m=8, n_centroids=64, iters=10)
    resid = tpq.train_pq(x, m=8, n_centroids=64, iters=10, coarse_centroids=64,
                         coarse_iters=8)
    assert resid.coarse is not None and resid.code_width == 10
    c_p, _ = tpq.pq_encode(x, plain)
    c_r, sq_r = tpq.pq_encode(x, resid)
    assert c_p.shape == (6144, 8) and c_r.shape == (6144, 10)
    rec_p = tpq.pq_reconstruct(c_p, plain).numpy()
    rec_r = tpq.pq_reconstruct(c_r, resid).numpy()
    err_p = np.mean(np.sum((rec_p - x.numpy()) ** 2, axis=1))
    err_r = np.mean(np.sum((rec_r - x.numpy()) ** 2, axis=1))
    assert err_r < 0.5 * err_p, (err_r, err_p)
    np.testing.assert_allclose(sq_r.numpy(), np.sum(rec_r * rec_r, axis=1), rtol=1e-4)


def test_opq_rotation_roundtrip_and_orthonormal(rng):
    d = 32
    scale = (np.arange(1, d + 1) ** -0.5).astype(np.float32)
    vecs = _t((rng.standard_normal((4096, d)) * scale).astype(np.float32))
    cb = tpq.train_pq(vecs, m=4, n_centroids=16, iters=4, sample_size=4096,
                      opq_iters=3)
    r = cb.rotation.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(d), atol=1e-4)
    buf = io.BytesIO()
    cb.save(buf)
    cb2 = tpq.PQCodebook.load(io.BytesIO(buf.getvalue()), device="cpu")
    np.testing.assert_array_equal(cb2.rotation.numpy(), r)
    codes, _ = tpq.pq_encode(vecs, cb)
    rec = tpq.pq_reconstruct(codes, cb, derotate=True).numpy()
    base = float(np.mean(vecs.numpy() ** 2))
    assert float(np.mean((rec - vecs.numpy()) ** 2)) < base * 0.6


def test_opq_improves_recall_on_anisotropic(rng):
    n, d, k = 8192, 64, 10
    scale = (np.arange(1, d + 1) ** -0.5).astype(np.float32)
    vecs = (rng.standard_normal((n, d)) * scale).astype(np.float32)
    qs = (rng.standard_normal((16, d)) * scale).astype(np.float32)
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    gt = np.argsort(-(qn @ vn.T), axis=1)[:, :k]

    def recall(opq_iters):
        cb = tpq.train_pq(_t(vecs), m=8, iters=6, sample_size=n, opq_iters=opq_iters)
        codes, sqn = tpq.pq_encode(_t(vecs), cb)
        _, ids = tpq.pq_scan_topk(_t(qs), codes, cb, sqn, torch.ones(n, dtype=torch.bool),
                                  k=k)
        return compute_recall(ids.numpy(), gt)

    r_pq, r_opq = recall(0), recall(4)
    assert r_opq > r_pq + 0.05, (r_pq, r_opq)


def test_default_subspaces_and_errors():
    assert tpq.default_subspaces(768) == jpq.default_subspaces(768) == 96
    assert tpq.default_subspaces(100) == jpq.default_subspaces(100)
    x = torch.zeros(64, 30)
    with pytest.raises(ValueError):
        tpq.train_pq(x, m=7)
    with pytest.raises(ValueError):
        tpq.train_pq(x, m=6, n_centroids=300)
    with pytest.raises(ValueError):
        tpq.PQCodebook.load(io.BytesIO(b"not a codebook"), device="cpu")


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pq_high_resource_search_launches_k1(cuda_device):
    """A high_resource PQ-cache search scans the f8 cache through K1's
    bf16 loop (D % 128 == 0, rows a multiple of 8192), then reranks: at
    least 95% of the ids of the plain scan of the cache (K1 keeps one row
    per 32-row bin) and of K1's plain version on the CPU. The noise
    (spread 0.5) keeps every code row distinct: at 0.15 half the rows
    share a code, and any choice among equal rows is right."""
    from coltt_tpu_torch.ops import fused_scan as fs
    from coltt_tpu_torch.store.flat import FlatStore

    rng = np.random.default_rng(11)
    centers = rng.standard_normal((48, 128)).astype(np.float32)
    x = _clustered(rng, 8192, 128, spread=0.5, centers=centers)
    q = _clustered(rng, 12, 128, spread=0.5, centers=centers)
    cb = tpq.train_pq(_t(x).to(cuda_device), m=16, n_centroids=64, iters=5, opq_iters=2)
    codes, _ = tpq.pq_encode(_t(x).to(cuda_device), cb)
    store = FlatStore.adopt_pq(cb, codes, device=cuda_device)
    key = ("float8_e4m3fn", fs.LOOP_BF16)
    before = fs.binmax_scan.launches_by.get(key, 0)
    _, fused = store.search(q, 10, fused=True, oversample=4)
    assert fs.binmax_scan.launches_by.get(key, 0) == before + 1
    _, plain = store.search(q, 10, oversample=4)
    cpu = FlatStore.adopt_pq(cb.to("cpu"), codes.cpu(), device="cpu")
    _, on_cpu = cpu.search(q, 10, fused=True, oversample=4)
    for other in (plain, on_cpu):
        assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(fused, other)]) >= 0.95

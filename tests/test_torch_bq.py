"""Port BQ ops vs the JAX package's on the same numpy inputs.

Tolerances, stated once:

- sign words: bit-identical (the reference's uint32, the port's int32);
  ``bq_decode``: equal;
- Hamming shortlists: the negated distances equal at every rank, and the
  ids equal: both packages rank equal distances by the lower row id
  (``lax.top_k`` on the CPU; the port's ``stable_topk``), in the popcount
  form, the +-1 form and its row blocks, with the reference's budget
  patched to the same value on both sides. Where a multi-block +-1 scan
  caps its per-block keep without ``exact`` (the reference's
  ``approx_max_k``, exact only on the CPU), the port leaves the tie group
  at a block's cut unsettled: the distances still equal at every rank,
  and each id is a distinct row at exactly its stated distance;
- ``hamming_to_neg_cos_dist``: within 1e-6 (``cos`` in f32 in both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coltt_tpu.ops.bq as jbq
import coltt_tpu_torch.ops.bq as tbq

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both(x):
    """The same rows packed by both packages: (JAX words, port words)."""
    return jbq.bq_encode(jnp.asarray(x)), tbq.bq_encode(_t(x))


@pytest.fixture
def budget(monkeypatch):
    """Patch the transient budget of both packages to one value."""
    def set_(nbytes):
        monkeypatch.setattr(jbq, "_BQ_TRANSIENT_BYTES", nbytes)
        monkeypatch.setattr(tbq, "_BQ_TRANSIENT_BYTES", nbytes)
        jbq.bq_scan_neg_topk.clear_cache()  # the budget is read at trace time
    yield set_
    jbq.bq_scan_neg_topk.clear_cache()


def _scan_both(jq, jc, tq, tc, valid, k, exact=False):
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else _t(valid)
    jh, ji = map(np.asarray, jbq.bq_scan_neg_topk(jq, jc, jv, k=k, exact=exact))
    th, ti = tbq.bq_scan_neg_topk(tq, tc, tv, k=k, exact=exact)
    return (jh, ji), (th.numpy(), ti.numpy())


def _assert_same(jres, tres):
    (jh, ji), (th, ti) = jres, tres
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(ti, ji)


def _assert_same_up_to_cut_ties(jres, tres, queries, codes, valid=None):
    """A capped keep's result: the distances equal at every rank; each id
    distinct and at exactly its stated distance (-inf: not valid)."""
    (jh, _), (th, ti) = jres, tres
    np.testing.assert_array_equal(th, jh)
    h = ((queries > 0)[:, None, :] != (codes > 0)[None, :, :]).sum(-1)
    for r in range(ti.shape[0]):
        assert len(set(ti[r].tolist())) == ti.shape[1]
        fin = np.isfinite(th[r])
        np.testing.assert_array_equal(-th[r][fin], h[r][ti[r][fin]])
        if valid is not None:
            assert valid[ti[r][fin]].all() and not valid[ti[r][~fin]].any()


@pytest.mark.parametrize("d", [32, 64, 100, 130, 768])
def test_encode_decode_bit_identical(rng, d):
    x = rng.standard_normal((7, d)).astype(np.float32)
    x[2, :5] = 0.0  # zero is not > 0 in either package
    jw, tw = _both(x)
    assert tw.dtype == torch.int32 and tw.shape == (7, tbq.bq_words(d))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(tbq.bq_decode(tw, d).numpy(),
                                  np.asarray(jbq.bq_decode(jw, d)))
    # leading dims pass through
    np.testing.assert_array_equal(tbq.bq_encode(_t(x.reshape(7, 1, d))).numpy(),
                                  tw.numpy().reshape(7, 1, -1))


def test_hamming_values_and_ids_match(rng):
    codes = rng.standard_normal((256, 64)).astype(np.float32)
    queries = rng.standard_normal((4, 64)).astype(np.float32)
    (jc, tc), (jq, tq) = _both(codes), _both(queries)
    valid = np.ones(256, bool)
    valid[10] = False
    jres, tres = _scan_both(jq, jc, tq, tc, valid, 256)
    _assert_same(jres, tres)
    # and both equal the numpy Hamming, ascending, tombstone last
    h = ((queries > 0)[:, None, :] != (codes > 0)[None, :, :]).sum(-1)
    th, ti = tres
    for r in range(4):
        fin = np.isfinite(th[r])
        np.testing.assert_array_equal(-th[r][fin], h[r][ti[r][fin]])
        assert ti[r][~fin].tolist() == [10]
    # the popcount and +-1 blocks agree with the reference's
    want = -np.asarray(jbq._hamming_block(jq, jc, None))
    np.testing.assert_array_equal(tbq._hamming(tq, tc).numpy(), want)
    np.testing.assert_array_equal(
        (64 - tbq._pm1_dots(tbq._unpack_pm1(tq, 64), tc).numpy()) // 2,
        -np.asarray(jbq._mxu_hamming_block(jbq._unpack_pm1(jq, 64), jc, None)))
    np.testing.assert_array_equal(tbq._unpack_pm1(tq, 64).numpy(),
                                  np.asarray(jbq._unpack_pm1(jq, 64)))


def test_blocked_scan_equals_unblocked(rng, budget):
    """n=32768, w=4, q=3 at a 768 KB budget: the +-1 form in row blocks
    (tests/test_bq.py's shapes); ids tie-broken identically."""
    codes = rng.standard_normal((32768, 128)).astype(np.float32)
    queries = rng.standard_normal((3, 128)).astype(np.float32)
    (jc, tc), (jq, tq) = _both(codes), _both(queries)
    whole = _scan_both(jq, jc, tq, tc, None, 10)
    _assert_same(*whole)
    budget(786432)
    blocked = _scan_both(jq, jc, tq, tc, None, 10)
    _assert_same_up_to_cut_ties(*blocked, queries, codes)
    _assert_same_up_to_cut_ties(whole[0], blocked[1], queries, codes)
    exact = _scan_both(jq, jc, tq, tc, None, 10, exact=True)
    _assert_same(*exact)
    _assert_same(whole[0], exact[1])


def test_blocked_scan_query_split(rng, budget):
    """n=16384, q=64, w=4 at a 64 KB budget (tests/test_bq.py's shapes),
    with a tombstone."""
    codes = rng.standard_normal((16384, 128)).astype(np.float32)
    queries = rng.standard_normal((64, 128)).astype(np.float32)
    (jc, tc), (jq, tq) = _both(codes), _both(queries)
    valid = np.ones(16384, bool)
    valid[42] = False
    whole = _scan_both(jq, jc, tq, tc, valid, 10)
    budget(64 << 10)
    blocked = _scan_both(jq, jc, tq, tc, valid, 10)
    _assert_same_up_to_cut_ties(*blocked, queries, codes, valid)
    _assert_same_up_to_cut_ties(whole[1], blocked[1], queries, codes, valid)
    exact = _scan_both(jq, jc, tq, tc, valid, 10, exact=True)
    _assert_same(*exact)
    _assert_same(whole[1], exact[1])


def test_popcount_query_chunks(rng, budget):
    """A scan over the budget whose rows do not divide by 8192 stays on
    the popcount form in both packages; the port chunks its queries."""
    (jc, tc), (jq, tq) = (_both(rng.standard_normal((5000, 96)).astype(np.float32)),
                          _both(rng.standard_normal((9, 96)).astype(np.float32)))
    budget(5000 * 3 * 4 * 2)  # two queries a chunk
    _assert_same(*_scan_both(jq, jc, tq, tc, None, 37))


@pytest.mark.parametrize("dim", [96, 100])
def test_mxu_form_matches_popcount(rng, budget, dim):
    """The +-1 product (dot = W*32 - 2*ham) equals the popcount form,
    tombstones and D % 32 != 0 included, in both packages."""
    codes = rng.standard_normal((16384, dim)).astype(np.float32)
    queries = rng.standard_normal((8, dim)).astype(np.float32)
    (jc, tc), (jq, tq) = _both(codes), _both(queries)
    valid = np.ones(16384, bool)
    valid[::5] = False
    popcount = _scan_both(jq, jc, tq, tc, valid, 12)
    budget(1 << 18)
    mxu = _scan_both(jq, jc, tq, tc, valid, 12)
    _assert_same_up_to_cut_ties(*mxu, queries, codes, valid)
    _assert_same_up_to_cut_ties(popcount[1], mxu[1], queries, codes, valid)
    exact = _scan_both(jq, jc, tq, tc, valid, 12, exact=True)
    _assert_same(*exact)
    _assert_same(popcount[1], exact[1])


@pytest.mark.parametrize("exact", [False, True])
def test_capped_block_keep_matches(rng, budget, exact):
    """16 blocks of the +-1 form with a k of 640: the capped per-block
    keep (max(64, 8*kk/blocks) rows) and the exact one agree with the
    reference's: the exact keep ids included, the capped one up to the tie
    groups at its blocks' cuts."""
    codes = rng.standard_normal((131072, 128)).astype(np.float32)
    queries = rng.standard_normal((4, 128)).astype(np.float32)
    (jc, tc), (jq, tq) = _both(codes), _both(queries)
    budget(3 << 20)
    res = _scan_both(jq, jc, tq, tc, None, 640, exact=exact)
    if exact:
        _assert_same(*res)
    else:
        _assert_same_up_to_cut_ties(*res, queries, codes)


def test_hamming_to_neg_cos_dist(rng):
    negh = -rng.integers(0, 769, (5, 12)).astype(np.float32)
    negh[1, 3] = -np.inf
    want = np.asarray(jbq.hamming_to_neg_cos_dist(jnp.asarray(negh), 768))
    got = tbq.hamming_to_neg_cos_dist(_t(negh), 768).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)


def test_plain_reference_scan_matches(rng):
    """The plain popcount top-k that the card's +-1 form is held to."""
    (jc, tc), (jq, tq) = (_both(rng.standard_normal((20000, 64)).astype(np.float32)),
                          _both(rng.standard_normal((3, 64)).astype(np.float32)))
    valid = rng.random(20000) > 0.1
    jres, _ = _scan_both(jq, jc, tq, tc, valid, 50)
    th, ti = tbq.bq_scan_neg_topk_ref(tq, tc, _t(valid), k=50, block=3000)
    _assert_same(jres, (th.numpy(), ti.numpy()))


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the +-1 form runs torch._int_mm there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [100, 768])
def test_mxu_form_on_card_matches_popcount(rng, cuda_device, monkeypatch, dim):
    """On the card the +-1 form (``torch._int_mm``, M padded past 16)
    equals the plain popcount, rank for rank, ids included."""
    codes = tbq.bq_encode(_t(rng.standard_normal((65536, dim)).astype(np.float32)))
    queries = tbq.bq_encode(_t(rng.standard_normal((5, dim)).astype(np.float32)))
    valid = _t(rng.random(65536) > 0.2)
    c, q, v = codes.to(cuda_device), queries.to(cuda_device), valid.to(cuda_device)
    # a 1 MB budget forces the +-1 form, in 8 row blocks, on the card
    monkeypatch.setattr(tbq, "_budget", lambda device: 1 << 20)
    got = tbq.bq_scan_neg_topk(q, c, v, k=160, exact=True)
    want = tbq.bq_scan_neg_topk_ref(q, c, v, k=160)
    cpu = tbq.bq_scan_neg_topk(queries, codes, valid, k=160)
    for a, b in ((got, want), (got, cpu)):
        np.testing.assert_array_equal(a[0].cpu().numpy(), b[0].cpu().numpy())
        np.testing.assert_array_equal(a[1].cpu().numpy(), b[1].cpu().numpy())


def test_bench_bq_small(monkeypatch):
    """bench_bq's corpus (slab by slab), its index and its measurement, at
    a small size on the CPU: the rerank copy restores recall@10."""
    from coltt_tpu_torch import bench, bench_bq
    from coltt_tpu_torch.parallel.dist_search import DistributedFlatIndex

    monkeypatch.setattr(bench_bq, "N_CENTERS", 64)
    monkeypatch.setattr(bench_bq, "SLAB", 2048)
    monkeypatch.setattr(bench, "P50_BATCHES", 1)
    g, centers = bench_bq.make_centers(0, "cpu")
    gq = torch.Generator().manual_seed(1)
    queries = bench.mixture_rows(gq, centers, 16, bench_bq.SIGMA)
    packed, rr, truth = bench_bq.make_corpus(5000, g, centers, queries)
    assert packed.shape == (5000, 24) and rr.dtype == torch.bfloat16
    idx = DistributedFlatIndex.from_bq_codes("cpu", packed, dim=768, rr_codes=rr)
    rec = bench_bq.measure(idx, queries, truth, [queries[:8]], 16)
    assert rec["recall_at_10"] >= 0.9 and rec["qps"] > 0 and rec["p50_batch_latency_ms"] > 0

"""The check's arithmetic on hand-built samples: ``miss_share`` counts
the exact top k an answer leaves out, a row given twice once, and under a
filter against the filtered top k; the reference ranks euclidean rows by
their distance, and cosine rows as it always did."""

import numpy as np
import pytest
import torch

from portbench import judge, reference

K = 10


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((64, 16)).astype(np.float32)
    pool = rng.standard_normal((4, 16)).astype(np.float32)
    _, top = reference.exact_topk(pool, rows, 64, "cosine", "cpu")
    return rows, pool, top


def _numbers(world, ids, flt=None):
    rows, pool, _ = world
    ids = np.asarray(ids, np.int64)
    sample = {"pool": np.arange(len(ids)), "count": np.full(len(ids), K),
              "ids": ids, "scores": reference.pair_scores(
                  pool, rows, np.repeat(np.arange(len(ids)), K), ids.ravel(),
                  "cosine", "cpu").reshape(ids.shape)}
    found = judge.numbers(sample, pool, rows, K, "cosine", "cpu", flt)
    assert abs(found["miss_share"] - (1.0 - found["recall_at_10"])) <= 1e-12
    return found


def test_exact_answers_miss_nothing(world):
    found = _numbers(world, world[2][:, :K])
    assert found["miss_share"] == 0.0 and found["missing_hits"] == 0


def test_one_wrong_row_in_ten_reads_a_tenth(world):
    ids = world[2][:, :K].copy()
    ids[:, 4] = world[2][:, K + 5]  # a valid row outside the exact top k
    assert _numbers(world, ids)["miss_share"] == pytest.approx(0.1, abs=1e-12)
    ids[:2] = world[2][:2, :K]      # two of the four answers exact again
    assert _numbers(world, ids)["miss_share"] == pytest.approx(0.05, abs=1e-12)


def test_a_repeated_row_counts_once(world):
    ids = world[2][:, :K].copy()
    ids[:, 9] = ids[:, 0]
    found = _numbers(world, ids)
    assert found["miss_share"] == pytest.approx(0.1, abs=1e-12)
    assert found["missing_hits"] == 4


def test_a_filtered_mix_counts_against_the_filtered_top_k(world):
    rows, pool, top = world
    flt = {"field": "row", "op": "GTE", "int": 32}
    filtered = np.stack([t[t >= 32][:K] for t in top])
    assert _numbers(world, filtered, flt)["miss_share"] == 0.0
    # the unfiltered top k: its rows under 32 are not rows the filter keeps
    unfiltered = top[:, :K]
    want = 1.0 - np.mean([len(np.intersect1d(u[u >= 32], f)) / K
                          for u, f in zip(unfiltered, filtered)])
    found = _numbers(world, unfiltered, flt)
    assert found["miss_share"] == pytest.approx(want, abs=1e-12) and want > 0


def test_euclidean_rows_rank_by_distance_past_the_score_floor():
    """Every row lies at squared distance 100 or more, where the 0-100
    score reads 0 for all: the top k is still the k nearest."""
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((3000, 16)) * 10).astype(np.float32)
    q = (rng.standard_normal((20, 16)) * 10).astype(np.float32)
    d = ((q[:, None, :].astype(np.float64) - rows[None]) ** 2).sum(-1)
    assert np.sort(d, 1)[:, K - 1].min() > 100
    scores, ids = reference.exact_topk(q, rows, K, "euclidean", "cpu")
    assert (ids == np.argsort(d, 1, kind="stable")[:, :K]).all()
    assert (scores == 0).all()


def test_euclidean_scores_keep_the_0_100_scale():
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((500, 8)).astype(np.float32)
    q = rows[:5] + 0.01
    scores, ids = reference.exact_topk(q, rows, K, "euclidean", "cpu")
    assert (ids[:, 0] == np.arange(5)).all()
    d = ((q[:, None, :] - rows[ids]) ** 2).sum(-1)
    assert np.allclose(scores, np.maximum(0.0, 100.0 - d), atol=1e-3)


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_cosine_ids_are_the_former_ranking(seed):
    """Cosine rows rank by their 0-100 score, bit for bit as the reference
    ranked them before it ranked euclidean rows by distance."""
    from portbench import data
    from tiny import EDGE

    rows, pool = data.make_rows(dict(EDGE["data"], pool=EDGE["query_pool"]),
                                EDGE["rows"], EDGE["dim"], seed, "cpu")
    scores, ids = reference.exact_topk(pool, rows, K, "cosine", "cpu")
    q, x = torch.from_numpy(pool), torch.from_numpy(rows)
    qn = q / q.norm(dim=1, keepdim=True).clamp(min=1e-30)
    xn = x / x.norm(dim=1, keepdim=True).clamp(min=1e-30)
    v, i = torch.topk(reference.normalize_score(1.0 - qn @ xn.t(), "cosine"), K, dim=1)
    assert (ids == i.numpy()).all() and (scores == v.numpy()).all()


def test_drop10_leaves_out_the_same_seeded_tenth():
    a, b = reference.reached(1000, 2**31 + 9), reference.reached(1000, 2**31 + 9)
    assert (a == b).all() and (~a).sum() == 100
    assert not (a == reference.reached(1000, 2**31 + 10)).all()
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((1000, 16)).astype(np.float32)
    q = rng.standard_normal((30, 16)).astype(np.float32)
    _, ids = reference.control_topk("drop10", q, rows, K, "cosine", "cpu", 2**31 + 9)
    assert a[ids].all()
    _, want = reference.exact_topk(q, rows[a], K, "cosine", "cpu")
    assert (ids == np.nonzero(a)[0][want]).all()

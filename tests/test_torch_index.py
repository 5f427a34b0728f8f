"""The port's host layers vs the JAX package: inverted index and batcher.

The port's Bitset keeps few ids as a set (the reference's word array costs
``slot / 8`` bytes per value, O(N^2) over a unique-valued field). The same
operations on both packages' indexes must give the same candidates, and
below 8192 rows the same checkpoint bytes; above, unique values go to a
``sparse`` section that the reference's loader skips.
"""

import threading

import numpy as np
import pytest

from coltt_tpu.index.bitmap import Bitset as JBitset
from coltt_tpu.index.bitmap import InvertedIndex as JInvertedIndex
from coltt_tpu.index.filter import filter_from_dict as j_filter_from_dict
from coltt_tpu_torch.engine.batcher import ScanBatcher
from coltt_tpu_torch.index.bitmap import Bitset, InvertedIndex
from coltt_tpu_torch.index.filter import And, Filter, Op, Or, filter_from_dict
from coltt_tpu_torch.utils import trace


def _fill(idx, n, seed=0):
    rng = np.random.default_rng(seed)
    for slot in range(n):
        idx.add(slot, {
            "pk": f"p{slot}",
            "tag": f"t{slot % 5}",
            "n": int(rng.integers(0, 50)),
            "ok": bool(slot % 3 == 0),
        })
    for slot in range(0, n, 11):
        idx.remove(slot, {"pk": f"p{slot}", "tag": f"t{slot % 5}"})


EXPRS = [
    Filter("tag", Op.EQ, "t2"),
    Filter("tag", Op.NEQ, "t2"),
    Filter("n", Op.GTE, 40),
    Filter("ok", Op.EQ, True),
    Filter("pk", Op.EQ, "p7"),
    Filter("pk", Op.EQ, "p22"),  # removed
    And(Filter("tag", Op.EQ, "t1"), Filter("n", Op.LT, 10)),
    Or(Filter("pk", Op.EQ, "p3"), Filter("pk", Op.EQ, "p1999"),
       Filter("tag", Op.EQ, "t4")),
    And(Filter("pk", Op.EQ, "p3"), Filter("ok", Op.EQ, True)),
]


@pytest.mark.parametrize("n", [300, 3000])
def test_index_matches_reference(n):
    ours, ref = InvertedIndex(fields=["pk", "tag"]), JInvertedIndex(fields=["pk", "tag"])
    _fill(ours, n)
    _fill(ref, n)
    for expr in EXPRS:
        want = ref.search(j_filter_from_dict(expr.to_dict())).ids()
        got = ours.search(expr).ids()
        np.testing.assert_array_equal(got, want, err_msg=str(expr.to_dict()))
        assert ours.search(expr).count() == len(want)
    # below 8192 rows the checkpoint bytes are the reference's
    assert ours.to_bytes() == ref.to_bytes()
    back = JInvertedIndex.from_bytes(ours.to_bytes())
    mine = InvertedIndex.from_bytes(ref.to_bytes())
    for expr in EXPRS:
        want = ref.search(j_filter_from_dict(expr.to_dict())).ids()
        np.testing.assert_array_equal(mine.search(expr).ids(), want)
        np.testing.assert_array_equal(
            back.search(j_filter_from_dict(expr.to_dict())).ids(), want)


def test_bitset_forms_agree_with_reference():
    rng = np.random.default_rng(1)
    for size in (5, 1024, 1025, 5000):
        a_ids = rng.choice(20000, size, replace=False)
        b_ids = rng.choice(20000, 700, replace=False)
        a, b = Bitset.from_ids(a_ids), Bitset.from_ids(b_ids)
        ja, jb = JBitset.from_ids(a_ids), JBitset.from_ids(b_ids)
        assert (a.sparse is None) == (size > 1024)
        for got, want in ((a & b, ja & jb), (a | b, ja | jb),
                          (a.andnot(b), ja.andnot(jb)), (b.andnot(a), jb.andnot(ja))):
            np.testing.assert_array_equal(got.ids(), want.ids())
            assert got.to_bytes() == want.to_bytes()
        np.testing.assert_array_equal(a.mask(30000), ja.mask(30000))
        assert a.test(int(a_ids[0])) and a.count() == size
        a.clear(int(a_ids[0]))
        assert not a.test(int(a_ids[0])) and a.count() == size - 1
    assert Bitset().to_bytes() == JBitset().to_bytes() == b""
    assert not Bitset().any()


def test_unique_values_stay_small_and_round_trip():
    """A primary key per row at 100k rows: the set form keeps memory and the
    checkpoint linear (the word-array encoding would be ~600 MB), and the
    sparse section round-trips."""
    n = 100_000
    idx = InvertedIndex(fields=["pk", "tag"])
    for slot in range(n):
        idx.add(slot, {"pk": f"p{slot}", "tag": f"t{slot % 8}"})
    blob = idx.to_bytes()
    assert len(blob) < 10 * n * 8
    back = InvertedIndex.from_bytes(blob)
    for expr in (Filter("pk", Op.EQ, "p99999"), Filter("pk", Op.EQ, "p5"),
                 Filter("tag", Op.EQ, "t3"),
                 And(Filter("tag", Op.EQ, "t7"), Filter("pk", Op.EQ, "p99999"))):
        np.testing.assert_array_equal(back.search(expr).ids(), idx.search(expr).ids())
    assert back.search(Filter("pk", Op.EQ, "p99999")).ids().tolist() == [99999]
    assert back.search(Filter("tag", Op.EQ, "t3")).count() == n // 8
    # the reference's loader reads the rest of the checkpoint
    ref = JInvertedIndex.from_bytes(blob)
    assert ref.search(j_filter_from_dict(Filter("tag", Op.EQ, "t3").to_dict())).count() \
        == n // 8


def test_filter_dicts_round_trip():
    for expr in EXPRS:
        assert filter_from_dict(expr.to_dict()).to_dict() == expr.to_dict()


def test_batcher_coalesces_and_routes_rows():
    """Concurrent submissions share scans and each gets its own rows back."""
    b = ScanBatcher(max_batch=64, max_wait_s=0.05)
    calls = []
    before = trace.counters()

    def scan_fn(q, k):
        calls.append(q.shape[0])
        ids = np.repeat(q[:, :1].astype(np.int32), k, axis=1)
        return q[:, :k].copy(), ids

    out = {}

    def submit(i, rows):
        v = np.full((rows, 4), float(i), np.float32)
        out[i] = b.run("key", scan_fn, v, 2)

    threads = [threading.Thread(target=submit, args=(i, 1 + i % 3)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    for i, (s, ids) in out.items():
        assert s.shape == (1 + i % 3, 2) and (ids == i).all()
    assert sum(calls) == sum(1 + i % 3 for i in range(8))
    assert len(calls) < 8
    # the process-wide counters agree with the scans the batcher ran
    grew = {k: trace.counters()[k] - before.get(k, 0)
            for k in ("batcher.groups", "batcher.requests", "batcher.rows")}
    assert grew == {"batcher.groups": len(calls), "batcher.requests": 8,
                    "batcher.rows": sum(calls)}

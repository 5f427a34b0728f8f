"""The end-to-end arithmetic: qps is all the work answered over the whole
window, the p95 is over every request, and the answer sample is uniform
and fixed by the seed."""

import numpy as np
import pytest

from portbench.client import Reservoir
from portbench.harness import end_to_end


def _recs(sent, done, nq, ok):
    return {"sent": np.asarray(sent, float), "done": np.asarray(done, float),
            "nq": np.asarray(nq), "ok": np.asarray(ok, bool)}


def test_qps_counts_all_work_in_the_window():
    # 4 requests of 100 queries answered inside a 2 s window, one answered
    # after it closed, one failed
    recs = _recs([0.0, 0.5, 1.0, 1.5, 1.9, 1.0], [0.4, 0.9, 1.4, 1.8, 2.3, 1.2],
                 [100] * 6, [True] * 5 + [False])
    out = end_to_end(recs, (0.0, 2.0), {"recall_at_10": 1.0}, 0, 1.0)
    assert out["qps"] == 400 / 2.0


def test_p95_is_over_every_request():
    lat = np.r_[np.full(90, 0.010), np.full(10, 0.100)]
    sent = np.arange(100) * 0.2
    recs = _recs(sent, sent + lat, np.ones(100, int), np.ones(100, bool))
    out = end_to_end(recs, (0.0, 100.0), {}, 0, 1.0)
    assert out["latency_p95_ms"] == pytest.approx(np.percentile(lat, 95) * 1e3)
    # a median of per-chunk p95s would miss the tail that sits in one chunk
    assert out["latency_p95_ms"] > 10.0


def test_reservoir_is_uniform_and_seeded():
    def fill(seed):
        r = Reservoir(64, 2, np.random.default_rng(seed))
        for start in range(0, 6400, 100):
            idx = np.arange(start, start + 100)
            r.offer(idx, [2] * 100, [str(i) for i in np.repeat(idx, 2)],
                    np.repeat(idx, 2).astype(float))
        return r.arrays()

    a, b = fill(1), fill(1)
    assert (a["pool"] == b["pool"]).all()
    assert len(a["pool"]) == 64 and len(set(a["pool"])) == 64
    assert (a["ids"][:, 0] == a["pool"]).all()
    # drawn from the whole stream, not its head
    assert a["pool"].max() > 3200 and a["pool"].min() < 3200
    many = np.concatenate([fill(s)["pool"] for s in range(40)])
    hist = np.histogram(many, bins=4, range=(0, 6400))[0]
    assert hist.min() > 0.8 * hist.mean()


def test_reservoir_reads_keys_as_rows():
    r = Reservoir(4, 3, np.random.default_rng(0))
    r.offer(np.array([5]), [2], ["17", "x9"], [99.0, 98.0])
    out = r.arrays()
    assert out["ids"][0].tolist() == [17, -2, -1]
    assert out["count"][0] == 2

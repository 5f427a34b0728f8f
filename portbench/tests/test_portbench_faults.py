"""A run with its timed path broken underneath comes out not correct.

Each fault is planted in the program's engine after ingest (the harness's
``hook``), so every request of the window goes through it: an answer
altered where it is produced (a hit's row, or its score), and half of a
batch left out, and a search that never reaches a seeded tenth of the
rows (deleted from the store under the engine)."""

import numpy as np
import pytest

from portbench import harness
from tiny import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("faults")))


def _other_row(pk):
    return str((int(pk) + 1) % 4096)


def alter_row_batch(dep):
    orig = dep.engine.search_batch

    def broken(*a, **kw):
        counts, scores, pks, mds = orig(*a, **kw)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int)
        for s in starts:
            pks[s] = _other_row(pks[s])
        return counts, scores, pks, mds

    dep.engine.search_batch = broken


def alter_score_batch(dep):
    orig = dep.engine.search_batch

    def broken(*a, **kw):
        counts, scores, pks, mds = orig(*a, **kw)
        return counts, [s - 2.0 for s in scores], pks, mds

    dep.engine.search_batch = broken


def half_batch_left_out(dep):
    orig = dep.engine.search_batch

    def broken(*a, **kw):
        counts, scores, pks, mds = orig(*a, **kw)
        half = len(counts) // 2
        keep = sum(counts[:half])
        return counts[:half] + [0] * (len(counts) - half), scores[:keep], \
            pks[:keep], mds

    dep.engine.search_batch = broken


def alter_row_search(dep):
    orig = dep.engine.search

    def broken(*a, **kw):
        hits = orig(*a, **kw)
        hits[0].id = _other_row(hits[0].id)
        return hits

    dep.engine.search = broken


def drop_a_tenth_of_the_rows(dep):
    store = dep.engine._collections[dep.collection].store
    n = dep.config["rows"]
    for row in np.random.default_rng(2**31 + 5).permutation(n)[:n // 10]:
        store.delete(str(row))


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.search"])
def test_rows_never_reached_fail_on_miss_share(root, cell):
    result = harness.run_cell(cell, 23, 1.0, False, device="cpu", repo=root,
                              hook=drop_a_tenth_of_the_rows)
    checked = result["checked"]
    assert result["correct"] is False, checked
    assert checked["miss_share"]["value"] > checked["miss_share"]["limit"]
    assert checked["score_gap"]["value"] <= checked["score_gap"]["limit"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny.batch", alter_row_batch),
    ("tiny.batch", alter_score_batch),
    ("tiny.batch", half_batch_left_out),
    ("tiny.search", alter_row_search),
])
def test_fault_is_not_correct(root, cell, fault):
    result = harness.run_cell(cell, 21, 1.0, False, device="cpu", repo=root,
                              hook=fault)
    assert result["correct"] is False, result["checked"]

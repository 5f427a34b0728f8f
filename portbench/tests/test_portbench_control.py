"""The controls of each cell's check, at a size a test run holds, judged
by the cell's own limits, come out not correct: the plain reference one
precision below the configuration's (int4 codes for the edge cells'
int8), and the exact reference that never reaches a seeded tenth of the
rows (``drop10``), which fails on its rows alone. The reference itself
passes. On the card the controls run at the cell's own size:
``python -m portbench.control --workload <cell> --seeds ...``."""

import numpy as np
import pytest

from portbench import control, judge, reference, spec
from tiny import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("control")))


CELLS = ["tiny.batch", "tiny.search", "tiny.filter"]


def test_each_tiny_cell_has_both_controls(root):
    for cell in CELLS:
        assert control.controls(spec.limits(cell, root)) == ["int4", "drop10"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", ["int4", "drop10"])
@pytest.mark.parametrize("seed", [1, 2**31 + 3, 77])
def test_control_fails_the_check(root, cell, name, seed):
    [out] = control.control_numbers(cell, seed, "cpu", repo=root, only=name)
    assert out["control"] == name and out["fails"], out
    if name == "drop10":
        # exact scores of rows it did reach: only the rows can fail it
        assert "miss_share" in out["fails"] and "score_gap" not in out["fails"]


def test_every_control_of_a_cell_runs_by_default(root):
    outs = control.control_numbers("tiny.batch", 5, "cpu", repo=root)
    assert [o["control"] for o in outs] == ["int4", "drop10"]
    assert all(o["fails"] for o in outs)


def test_a_single_control_name_still_parses():
    assert control.controls({"control": "int4"}) == ["int4"]
    assert control.controls({"control": ["tf32", "drop10"]}) == ["tf32", "drop10"]


def test_reference_in_its_own_precision_passes(root):
    bench = spec.benchmark(root)
    cell = spec.workload(bench, "tiny.batch")
    cfg = spec.config(bench, cell, root)
    from portbench import data

    rows, pool = data.make_rows(dict(cfg["data"], pool=cfg["query_pool"]),
                                cfg["rows"], cfg["dim"], 5, "cpu")
    pidx = np.arange(64)
    s, i = reference.exact_topk(pool[pidx], rows, 10, cfg["metric"], "cpu")
    sample = {"pool": pidx, "count": np.full(64, 10), "ids": i, "scores": s}
    found = judge.numbers(sample, pool, rows, 10, cfg["metric"], "cpu")
    assert found["missing_hits"] == 0
    assert found["score_gap"] < 1e-4 and found["rank_gap"] < 1e-4
    assert found["recall_at_10"] == 1.0 and found["miss_share"] == 0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    import torch

    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-12, 3.0e-3], dtype=torch.float32)
    y = reference.tf32_operands(x)
    assert y[0] == x[0]
    assert y[1] == 1.0
    assert abs(y[2] - x[2]) <= x[2] * 2**-11

"""The control of each cell's check, at a size a test run holds: the
plain reference one precision below the configuration's (int4 codes for
the edge cells' int8), judged by
the cell's own limits, comes out not correct; the reference itself
passes. On the card the control runs at the cell's own size:
``python -m portbench.control --workload <cell> --seeds ...``."""

import numpy as np
import pytest

from portbench import control, judge, reference, spec
from tiny import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("control")))


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.search", "tiny.filter"])
@pytest.mark.parametrize("seed", [1, 2**31 + 3, 77])
def test_control_fails_the_check(root, cell, seed):
    out = control.control_numbers(cell, seed, "cpu", repo=root)
    assert out["fails"], out


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
    assert found["recall_at_10"] == 1.0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    import torch

    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-12, 3.0e-3], dtype=torch.float32)
    y = reference.tf32_operands(x)
    assert y[0] == x[0]
    assert y[1] == 1.0
    assert abs(y[2] - x[2]) <= x[2] * 2**-11

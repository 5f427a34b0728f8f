"""The port's beam builder ``bulk_build`` against the JAX package's on the
same data and seed, held by recall@10 (``tests/torch_hnsw_cases.py``)."""

import numpy as np
import pytest

from coltt_tpu_torch.store.hnsw import HnswIndex
from torch_hnsw_cases import CASES, check_builder, make_data  # pytest puts tests/ on the path


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("bulk_build-")
                                  or c == "bulk_build"])
def test_builder_recall_matches_the_reference(data, case):
    check_builder(data, case)


def test_builders_require_an_empty_index():
    idx = HnswIndex(8, device="cpu")
    idx.insert(np.ones(8, np.float32))
    with pytest.raises(RuntimeError):
        idx.bulk_build(np.ones((4, 8), np.float32))
    with pytest.raises(RuntimeError):
        idx.bulk_build_clustered(np.ones((4, 8), np.float32))

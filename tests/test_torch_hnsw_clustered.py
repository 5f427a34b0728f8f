"""The port's clustered builders (``bulk_build_clustered``, NN-descent,
``beam_refine``, ``bulk_build_auto``) against the JAX package's on the
same data and seed, held by recall@10 (``tests/torch_hnsw_cases.py``);
their determinism and the reverse pass's chunking."""

import numpy as np
import pytest
import torch

from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.store.hnsw import HnswConfig, HnswIndex
from torch_hnsw_cases import (  # pytest puts tests/ on the path
    CASES, DIM, HEUR, N, build, check_builder, make_data,
)


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.mark.parametrize("case", [c for c in CASES if not c.startswith("bulk_build")
                                  or c == "bulk_build_auto"])
def test_builder_recall_matches_the_reference(data, case):
    check_builder(data, case)


def test_bulk_build_auto_is_deterministic(data):
    """The same rows and seed build the same graph (a restart that rebuilds
    a collection from its commit log returns the same ids)."""
    vecs, _ = data
    a, b = (build("torch", HEUR, Metric.COSINE,
                   lambda i, v: i.bulk_build_auto(v, cluster_size=256), vecs)
            for _ in range(2))
    assert (a._entry, a._max_level) == (b._entry, b._max_level)
    for x, y in zip(a._adj, b._adj):
        np.testing.assert_array_equal(x, y)


def test_reverse_pass_chunks_change_no_edge(data):
    """The reverse pass's row chunks come from free memory; any chunk size
    gives the same edges."""
    vecs, _ = data
    idx = HnswIndex(DIM, config=HnswConfig(**HEUR), seed=1, device="cpu")
    idx.bulk_build_clustered(vecs, cluster_size=256, seed=2)
    d_vecs = torch.tensor(idx._vecs).to(torch.bfloat16)
    d_sqn = torch.tensor(idx._sqn)
    rng = np.random.default_rng(4)
    nbr = rng.integers(0, N, 3000).astype(np.int32)
    newp = rng.integers(0, N, 3000).astype(np.int32)
    outs = []
    for chunk in (None, 7):
        adj = torch.tensor(idx._adj[0])
        idx._reverse_connect(d_vecs, d_sqn, adj, nbr, newp,
                             compute_dtype=torch.bfloat16, chunk_rows=chunk)
        outs.append(adj)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], torch.tensor(idx._adj[0]))


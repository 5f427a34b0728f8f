"""Shared cases of the HNSW builder tests (``test_torch_hnsw_build.py``,
``test_torch_hnsw_clustered.py``): each builder runs in both packages on
the same data and seed, and the port is held by recall@10 (no more than
0.02 below the reference's, and above the floors of ``test_hnsw.py``)."""

import io

import numpy as np
import torch

import jax.numpy as jnp

from coltt_tpu.ops.distance import Metric as JMetric
from coltt_tpu.store.hnsw import HnswConfig as JConfig
from coltt_tpu.store.hnsw import HnswIndex as JIndex
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.store.hnsw import HEURISTIC, HnswConfig, HnswIndex

N, DIM = 2000, 24


def make_data():
    rng = np.random.default_rng(31)
    vecs = rng.standard_normal((N, DIM), dtype=np.float32)
    qs = rng.standard_normal((40, DIM), dtype=np.float32)
    return vecs, qs


def recall(vecs, qs, ids, metric):
    if metric == Metric.COSINE:
        d = 1 - (qs @ vecs.T) / (np.linalg.norm(qs, axis=1)[:, None]
                                 * np.linalg.norm(vecs, axis=1)[None, :])
    else:
        d = ((qs[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    truth = np.argsort(d, axis=1)[:, :10]
    return np.mean([len(set(t) & set(r.tolist())) / 10 for t, r in zip(truth, ids)])


def build(pkg, cfg, metric, how, vecs, device_dtype=None):
    if pkg == "jax":
        idx = JIndex(DIM, metric=JMetric(int(metric)), config=JConfig(**cfg), seed=1,
                     device_dtype=jnp.bfloat16 if device_dtype else jnp.float32)
    else:
        idx = HnswIndex(DIM, metric=metric, config=HnswConfig(**cfg), seed=1,
                        device="cpu", device_dtype=device_dtype or torch.float32)
    how(idx, vecs)
    return idx


SIMPLE = dict(m=8, ef_construction=60)
HEUR = dict(m=8, ef_construction=60, algorithm=HEURISTIC)

CASES = {
    # builder, config, metric, serving ef, floor (test_hnsw.py's), bf16 graph
    "bulk_build": (lambda i, v: i.bulk_build(v[:1200], seed_size=64, batch_rows=256),
                   SIMPLE, Metric.COSINE, 64, 0.9, False),
    "bulk_build-heuristic-euclidean": (
        lambda i, v: i.bulk_build(v[:600], seed_size=48, batch_rows=128),
        dict(m=6, ef_construction=40, algorithm=HEURISTIC), Metric.EUCLIDEAN,
        48, 0.85, False),
    "bulk_build-bf16-graph": (
        lambda i, v: i.bulk_build(v[:500], seed_size=64, batch_rows=128),
        dict(m=8, ef_construction=48), Metric.COSINE, 64, 0.85, True),
    "clustered": (lambda i, v: i.bulk_build_clustered(v, cluster_size=256, seed=2),
                  HEUR, Metric.COSINE, 80, 0.9, False),
    "clustered-euclidean-single-block": (
        lambda i, v: i.bulk_build_clustered(v[:700], seed=4),
        dict(m=6, ef_construction=40, algorithm=HEURISTIC), Metric.EUCLIDEAN,
        60, 0.85, False),
    "clustered+nn-descent": (
        lambda i, v: i.bulk_build_clustered(v, cluster_size=256, seed=2,
                                            descent_rounds=1),
        HEUR, Metric.COSINE, 80, 0.9, False),
    "clustered+beam_refine": (
        lambda i, v: (i.bulk_build_clustered(v, cluster_size=256, seed=2),
                      i.beam_refine(rounds=1, batch_rows=1024)),
        HEUR, Metric.COSINE, 80, 0.9, False),
    "bulk_build_auto": (lambda i, v: i.bulk_build_auto(v, cluster_size=256, seed=2),
                        HEUR, Metric.COSINE, 80, 0.9, False),
}


def check_builder(data, case):
    how, cfg, metric, ef, floor, bf16 = CASES[case]
    vecs, qs = data
    got = {}
    for pkg in ("jax", "torch"):
        idx = build(pkg, cfg, metric, how, vecs, torch.bfloat16 if bf16 else None)
        n = idx._next
        got[pkg] = recall(vecs[:n], qs, idx.search(qs, 10, ef=ef)[1], metric)
        if pkg == "torch":
            port = idx
    assert got["torch"] >= got["jax"] - 0.02, got
    assert got["torch"] >= floor, got
    # the built index stays mutable and snapshots
    extra = np.random.default_rng(3).standard_normal(DIM).astype(np.float32)
    s = port.insert(extra)
    assert port.search(extra, k=1, ef=32)[1][0, 0] == s
    assert port.remove(s)
    buf = io.BytesIO()
    port.save(buf)
    buf.seek(0)
    again = HnswIndex.load(buf, device="cpu", device_dtype=port.device_dtype)
    np.testing.assert_array_equal(again.search(qs[:3], 5)[1], port.search(qs[:3], 5)[1])

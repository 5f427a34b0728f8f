"""PQ bench of the port: QPS, p50 and recall@10 on one GPU.

    python -m coltt_tpu_torch.bench_pq [--rows 1048576] [--seed 0]
                                       [--dsub 4] [--coarse 16384]

The serving configurations of the JAX package's ``bench_pq.py`` on its
corpus recipe: 768d rows from a mixture of 16,384 centres whose centres
and noise (sigma 0.35) decay per dim as i^-0.5, made on the card from
``--seed`` in 1,048,576-row slabs. By default the reference's residual
OPQ configuration: a 16,384-centroid coarse quantizer and subspaces of
``--dsub`` 4 (M=192, 194 bytes a row; ``--coarse 0`` for plain OPQ),
trained with 10 Lloyd iterations and 4 OPQ rounds on a 262,144-row sample
of the mixture; every slab then encoded with ``pq_encode`` and scored
exactly (f32, TF32 off) against the eval queries before it is dropped.
``--rows`` is rounded up to the 8192-row capacity quantum and takes
10,000,000 too.

Paths, each through ``FlatStore.search`` on the same codes:

- ``f8cache``: ``FlatStore.adopt_pq`` with the f8 reconstruction cache
  (its build timed), a ``high_resource`` search: K1 over the cache, a
  k x 4 shortlist reranked against the exact reconstruction;
- ``adc``: ``pq_cache=False``, the blocked ADC scan over the codes;
- ``snapshot``: the f8cache store saved to a temporary file and loaded
  back (codes read, cache rebuilt: both timed), then searched again.

Per path: the p50 of 5 synchronous 2048-query searches, the QPS of
rounds of 4 searches on 4 threads (median of 5 after 2) and recall@10 of
1024 queries against the exact top-10. Prints one JSON line on stdout,
with the card's name and power limit; progress goes to stderr. Without a
CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from coltt_tpu_torch.bench import card, log, merge_truth, mixture_rows
from coltt_tpu_torch.ops import fused_scan as fs
from coltt_tpu_torch.ops.pq import default_subspaces, pq_encode, train_pq
from coltt_tpu_torch.ops.topk import compute_recall
from coltt_tpu_torch.store.flat import _CAPACITY_QUANTUM, FlatStore

DIM = 768
K = 10
N_CENTERS = 16_384
SIGMA = 0.35
SLAB = 1 << 20
TRAIN_ROWS = 262_144
BATCH = 2048
DEPTH = 4
WARM = 2
ROUNDS = 5
P50_BATCHES = 5
RECALL_QUERIES = 1024
OVERSAMPLE = 4


def make_centers(seed: int, device):
    """``(generator, centres, per-dim spectrum)``: the generator then
    makes the rows; centres and noise both carry the i^-0.5 decay."""
    g = torch.Generator(device=device).manual_seed(seed)
    spectrum = torch.arange(1, DIM + 1, device=device, dtype=torch.float32) ** -0.5
    return g, torch.randn((N_CENTERS, DIM), generator=g, device=device) * spectrum, spectrum


def rows_of(g, centers, spectrum, n):
    return mixture_rows(g, centers, n, SIGMA, spectrum)


def encode_corpus(rows: int, g, centers, spectrum, codebook, queries):
    """``(codes [rows, code_width] uint8, exact top-10 ids of queries)``,
    the rows made, encoded and scored slab by slab."""
    codes = torch.empty((rows, codebook.code_width), dtype=torch.uint8,
                        device=centers.device)
    best = None
    for off in range(0, rows, SLAB):
        x = rows_of(g, centers, spectrum, min(SLAB, rows - off))
        codes[off:off + x.shape[0]] = pq_encode(x, codebook)[0]
        best = merge_truth(best, queries, x, off)
        del x
    return codes, best[1].cpu().numpy()


def measure(store: FlatStore, queries: np.ndarray, truth, q_batches, **kw) -> dict:
    """p50 of synchronous searches, threaded QPS, recall@10 of a store."""
    def search(q):
        return store.search(q, K, **kw)

    t0 = time.perf_counter()
    search(q_batches[0])
    warmup_s = time.perf_counter() - t0
    lats = []
    for i in range(P50_BATCHES):
        t0 = time.perf_counter()
        search(q_batches[i % len(q_batches)])
        lats.append((time.perf_counter() - t0) * 1e3)
    qps_rounds = []
    with ThreadPoolExecutor(len(q_batches)) as pool:
        for r in range(WARM + ROUNDS):
            t0 = time.perf_counter()
            for fut in [pool.submit(search, q) for q in q_batches]:
                fut.result()
            if r >= WARM:
                qps_rounds.append(len(q_batches) * q_batches[0].shape[0]
                                  / (time.perf_counter() - t0))
    ids = np.concatenate([search(queries[i:i + BATCH])[1]
                          for i in range(0, len(queries), BATCH)])
    return {"qps": round(statistics.median(qps_rounds), 1),
            "qps_rounds": [round(x, 1) for x in qps_rounds],
            "p50_batch_latency_ms": round(statistics.median(lats), 3),
            "recall_at_10": round(float(compute_recall(ids, truth)), 4),
            "warmup_s": round(warmup_s, 2), "ids": ids}


def _public(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "ids"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=SLAB)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dsub", type=int, default=4)
    ap.add_argument("--coarse", type=int, default=16_384)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_pq: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    dev = card()
    log(f"device: {dev}")
    rows = -(-args.rows // _CAPACITY_QUANTUM) * _CAPACITY_QUANTUM
    m = default_subspaces(DIM, target_dsub=args.dsub)

    g, centers, spectrum = make_centers(args.seed, device)
    gq = torch.Generator(device=device).manual_seed(args.seed + 1)
    queries = rows_of(gq, centers, spectrum, RECALL_QUERIES)
    q_batches = [rows_of(gq, centers, spectrum, BATCH).cpu().numpy()
                 for _ in range(DEPTH)]
    t0 = time.perf_counter()
    codebook = train_pq(
        rows_of(torch.Generator(device=device).manual_seed(args.seed + 2),
                centers, spectrum, TRAIN_ROWS),
        m=m, iters=10, opq_iters=4, sample_size=TRAIN_ROWS,
        coarse_centroids=args.coarse,
        generator=torch.Generator(device=device).manual_seed(args.seed + 3))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    log(f"OPQ+PQ train (M={m}, coarse={args.coarse}): {train_s:.1f} s")
    t0 = time.perf_counter()
    codes, truth = encode_corpus(rows, g, centers, spectrum, codebook, queries)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    log(f"{rows} rows made, encoded and ground-truthed: {encode_s:.1f} s")
    queries = queries.cpu().numpy()

    t0 = time.perf_counter()
    store = FlatStore.adopt_pq(codebook, codes, device=device)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    fs.reset_launch_counts()
    paths = {"f8cache": measure(store, queries, truth, q_batches, fused=True,
                                oversample=OVERSAMPLE)}
    k1_launches = dict(fs.binmax_scan.launches_by)
    adc = FlatStore.adopt_pq(codebook, codes, pq_cache=False, device=device)
    paths["adc"] = measure(adc, queries, truth, q_batches)
    del adc

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pq.snapshot")
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            store.save(f)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        del store
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            loaded = FlatStore.load(f, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    paths["snapshot"] = measure(loaded, queries, truth, q_batches, fused=True,
                                oversample=OVERSAMPLE)
    same = bool((paths["snapshot"]["ids"] == paths["f8cache"]["ids"]).all())
    for name, rec in paths.items():
        log(f"[{name}] {json.dumps(_public(rec))}")
    head = paths["f8cache"]
    print(json.dumps({
        "metric": (f"{f'coarse{args.coarse}-residual-' if args.coarse else ''}OPQ"
                   f"(M={m}) + f8 cache (K1) + reconstruction rerank QPS on one "
                   f"GPU at recall@{K} ({rows} x {DIM}d clustered + spectrum, "
                   f"batch={BATCH}, {DEPTH} threads)"),
        "value": head["qps"],
        "unit": "qps",
        "recall_at_10": head["recall_at_10"],
        "p50_batch_latency_ms": head["p50_batch_latency_ms"],
        "paths": {name: _public(rec) for name, rec in paths.items()},
        "k1_launches_f8cache": {f"{c}/{loop}": n for (c, loop), n in k1_launches.items()},
        "train_s": round(train_s, 2), "encode_s": round(encode_s, 2),
        "cache_build_s": round(cache_s, 3), "save_s": round(save_s, 2),
        "load_s": round(load_s, 2), "snapshot_bytes": size,
        "reload_same_ids": same, "rows": rows, "m": m, "coarse": args.coarse,
        "seed": args.seed, "device": dev,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Filtered-search selectivity sweep of the port on one GPU.

    python -m coltt_tpu_torch.bench_filtered [--rows 1000000] [--seed 0]

The configuration of the JAX package's ``bench_filtered.py``: an I8
cosine FlatStore of 1M x 768d gaussian rows (made on the card from
``--seed`` and bulk-built there) and its f32 twin for the ground truth,
512-query batches, k=10, a random candidate set per selectivity (the
inverted index's output in a filtered search). ``FlatStore.search(...,
candidates=...)`` has two regimes: below ``capacity // _GATHER_FRACTION``
candidates it gathers the candidate rows and scans them with the plain
scan, above it masks the whole store, which the plain scan reads by
default and K1 under ``fused=True`` (the edge server's high_resource
search). At every selectivity from 1% up all three are measured (the
module constant set to 1 or to 2^30 for the call), below it the automatic
choice; each crossover, the least selectivity at which a masked scan is
at least as fast as the gathered one, is what ``_GATHER_FRACTION`` is
held to for that kind of traffic.

Per point: QPS of synchronous searches (host clock, each ending in the
results' copy to the host), the median of 11 after 2 warm-ups, the
regimes taking turns in every round so that drift of the host falls on
all of them alike; the device memory a search allocates above the
stores' own (peak of the warm-ups); and recall@10 of the batch against
the f32 store under the same candidates. Prints one JSON line on stdout,
with the card's name and power limit; progress goes to stderr; writes no
file. Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import coltt_tpu_torch.store.flat as flat_mod
from coltt_tpu_torch.bench import card, log
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.ops.topk import compute_recall
from coltt_tpu_torch.store.flat import FlatStore

DIM = 768
K = 10
BATCH = 512
WARM = 2
ROUNDS = 11
SELECTIVITIES = (0.0001, 0.001, 0.01, 0.05, 0.1, 0.125, 0.167, 0.25, 0.35,
                 0.5, 0.75, 0.9)
BOTH_FROM = 0.01  # every regime measured at and above this selectivity
# regime -> (the _GATHER_FRACTION of its calls, fused); None keeps the store's
REGIMES = {"auto": (None, False), "gather": (1, False), "masked": (1 << 30, False),
           "masked_k1": (1 << 30, True)}


def _search(store, queries, cand, regime: str):
    fraction, fused = REGIMES[regime]
    old = flat_mod._GATHER_FRACTION
    flat_mod._GATHER_FRACTION = old if fraction is None else fraction
    try:
        return store.search(queries, K, candidates=cand, fused=fused)[1]
    finally:
        flat_mod._GATHER_FRACTION = old


def measure(store, gt, queries, cand, regimes) -> dict:
    """``{regime: QPS, recall@10 and extra device MiB}`` of filtered
    searches, the regimes in turns."""
    out = {}
    for regime in regimes:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WARM):
            got = _search(store, queries, cand, regime)
        out[regime] = {"candidates": int(cand.size), "qps": [],
                       "peak_extra_mib": round(
                           (torch.cuda.max_memory_allocated() - base) / 2**20, 1)}
    for _ in range(ROUNDS):
        for regime in regimes:
            t0 = time.perf_counter()
            _search(store, queries, cand, regime)
            out[regime]["qps"].append(queries.shape[0] / (time.perf_counter() - t0))
    truth = gt.search(queries, K, candidates=cand)[1]
    for regime in regimes:
        qps = out[regime].pop("qps")
        out[regime]["qps_median"] = round(float(np.median(qps)), 1)
        out[regime]["qps_iqr"] = [round(float(x), 1) for x in np.percentile(qps, (25, 75))]
        out[regime]["recall_at_10"] = round(float(compute_recall(
            _search(store, queries, cand, regime), truth)), 4)
    return out


def crossover(results: dict, masked: str):
    """The least selectivity at which the ``masked`` regime is at least as
    fast as the gathered one (None if the gathered one wins everywhere)."""
    for frac in SELECTIVITIES:
        g, m = results.get(f"{frac:g}/gather"), results.get(f"{frac:g}/{masked}")
        if g and m and m["qps_median"] >= g["qps_median"]:
            return frac
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_filtered: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    dev = card()
    log(f"device: {dev}")

    n = args.rows
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    vecs = torch.randn((n, DIM), generator=gen, device=device)
    queries = torch.randn((BATCH, DIM), generator=gen, device=device).cpu().numpy()
    pks = [str(i) for i in range(n)]
    store = FlatStore(DIM, metric=Metric.COSINE, quantization=Quantization.I8,
                      device=device)
    gt = FlatStore(DIM, metric=Metric.COSINE, quantization=Quantization.NONE,
                   device=device)
    store.bulk_build(pks, vecs)
    gt.bulk_build(pks, vecs)
    del vecs
    torch.cuda.synchronize()
    log(f"{n} x {DIM} rows made, I8 and f32 stores built: "
        f"{time.perf_counter() - t0:.1f} s (capacity {store.capacity}, "
        f"gather below {store.capacity // flat_mod._GATHER_FRACTION} candidates)")

    rng = np.random.default_rng(args.seed)
    results = {}
    for frac in SELECTIVITIES:
        cand = rng.choice(n, size=max(K, int(n * frac)), replace=False).astype(np.int32)
        regimes = ("gather", "masked", "masked_k1") if frac >= BOTH_FROM else ("auto",)
        for regime, rec in measure(store, gt, queries, cand, regimes).items():
            key = f"{frac:g}" + ("" if regime == "auto" else f"/{regime}")
            results[key] = rec
            log(f"sel {key}: {json.dumps(rec)}")
    cross = {m: crossover(results, m) for m in ("masked", "masked_k1")}
    log(f"a masked scan at least as fast as the gathered one from selectivity "
        f"{cross} (capacity // {flat_mod._GATHER_FRACTION} = "
        f"{store.capacity // flat_mod._GATHER_FRACTION / store.capacity:.4f} now)")
    print(json.dumps({
        "metric": f"filtered FLAT i8 QPS on one GPU at recall@{K} by selectivity "
                  f"({n} x {DIM}d, batch={BATCH}, median of {ROUNDS})",
        "value": results["0.01/gather"]["qps_median"],
        "unit": "qps",
        "selectivities": results,
        "masked_from_selectivity": cross,
        "gather_fraction": flat_mod._GATHER_FRACTION,
        "capacity": store.capacity,
        "rows": n,
        "seed": args.seed,
        "device": dev,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

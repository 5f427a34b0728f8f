"""BQ bench of the port: QPS, p50 and recall@10 on one GPU.

    python -m coltt_tpu_torch.bench_bq [--rows 1048576] [--seed 0]

The serving configurations of the JAX package's ``bench_bq.py`` on its
corpus recipe: 768d rows from a mixture of 16,384 gaussian centres with
noise sigma 0.35, made on the card from ``--seed`` in 1,048,576-row slabs
and packed with ``bq_encode`` as they are made (the f32 rows never
accumulate; a bf16 copy is kept for the rerank). Two indexes over the
same packed words (``DistributedFlatIndex.from_bq_codes``): with the bf16
rerank copy, and without one (the random-hyperplane angle estimate ranks
alone), each searched at oversample 16 and 64. ``--rows`` takes
10,000,000 too (the bf16 copy is then 15.4 GB).

Measured on the card, per configuration: the p50 of 5 synchronous
2048-query batches and the queued QPS (``bench.time_dispatch``: 4
batches queued a round, median of 5 rounds after 2), and recall@10 of
2048 queries of the same mixture against the exact f32 cosine top-10
over every slab (TF32 off). Prints one JSON line on stdout, with the
card's name and power limit; progress goes to stderr. Without a CUDA
device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from coltt_tpu_torch.bench import card, log, merge_truth, mixture_rows, time_dispatch
from coltt_tpu_torch.ops.bq import bq_encode, bq_words
from coltt_tpu_torch.ops.topk import compute_recall
from coltt_tpu_torch.parallel.dist_search import DistributedFlatIndex

DIM = 768
K = 10
N_CENTERS = 16_384
SIGMA = 0.35
SLAB = 1 << 20
BATCH = 2048
DEPTH = 4
RECALL_QUERIES = 2048
OVERSAMPLES = (16, 64)


def make_centers(seed: int, device):
    """``(generator, centres)``: the generator that then makes the rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    return g, torch.randn((N_CENTERS, DIM), generator=g, device=device)


def make_corpus(rows: int, g: torch.Generator, centers: torch.Tensor,
                queries: torch.Tensor):
    """``(packed words [rows, 24] int32, bf16 rows [rows, 768], exact
    top-10 ids of queries)``, the rows made slab by slab from ``g``."""
    device = centers.device
    packed = torch.empty((rows, bq_words(DIM)), dtype=torch.int32, device=device)
    rr = torch.empty((rows, DIM), dtype=torch.bfloat16, device=device)
    best = None
    for off in range(0, rows, SLAB):
        x = mixture_rows(g, centers, min(SLAB, rows - off), SIGMA)
        packed[off:off + x.shape[0]] = bq_encode(x)
        rr[off:off + x.shape[0]] = x.to(torch.bfloat16)
        best = merge_truth(best, queries, x, off)
        del x
    return packed, rr, best[1].cpu().numpy()


def measure(idx, queries: torch.Tensor, truth, q_batches, oversample: int) -> dict:
    """One configuration: p50, queued QPS and recall@10."""
    def dispatch(q):
        return idx.search_tensors(q, K, oversample=oversample)

    warmup_s, p50_ms, qps, rounds = time_dispatch(dispatch, q_batches)
    got = np.concatenate([idx.search(queries[i:i + BATCH].cpu().numpy(), K,
                                     oversample=oversample)[1]
                          for i in range(0, queries.shape[0], BATCH)])
    return {"qps": round(qps, 1), "qps_rounds": [round(x, 1) for x in rounds],
            "p50_batch_latency_ms": round(p50_ms, 3),
            "recall_at_10": round(float(compute_recall(got, truth)), 4),
            "warmup_s": round(warmup_s, 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=SLAB)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_bq: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    dev = card()
    log(f"device: {dev}")

    t0 = time.perf_counter()
    g, centers = make_centers(args.seed, device)
    gq = torch.Generator(device=device).manual_seed(args.seed + 1)
    queries = mixture_rows(gq, centers, RECALL_QUERIES, SIGMA)
    q_batches = [mixture_rows(gq, centers, BATCH, SIGMA) for _ in range(DEPTH)]
    packed, rr, truth = make_corpus(args.rows, g, centers, queries)
    torch.cuda.synchronize()
    log(f"{args.rows} x {DIM} rows made, packed and ground-truthed: "
        f"{time.perf_counter() - t0:.1f} s")

    configs = {}
    for name, copy in (("bf16-rerank", rr), ("no-rerank", None)):
        idx = DistributedFlatIndex.from_bq_codes(device, packed, dim=DIM, rr_codes=copy)
        for os_ in OVERSAMPLES:
            rec = measure(idx, queries, truth, q_batches, os_)
            configs[f"{name} os{os_}"] = rec
            log(f"[{name} os{os_}] {json.dumps(rec)}")
        del idx
        torch.cuda.empty_cache()
    head = configs[f"bf16-rerank os{OVERSAMPLES[0]}"]
    print(json.dumps({
        "metric": f"BQ packed-Hamming + bf16 rerank QPS on one GPU at recall@{K} "
                  f"({args.rows} x {DIM}d cluster mixture, oversample "
                  f"{OVERSAMPLES[0]}, batch={BATCH}, queued depth={DEPTH})",
        "value": head["qps"],
        "unit": "qps",
        "recall_at_10": head["recall_at_10"],
        "p50_batch_latency_ms": head["p50_batch_latency_ms"],
        "configs": configs,
        "rows": args.rows,
        "packed_bytes": packed.numel() * 4,
        "seed": args.seed,
        "device": dev,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CFLAT bench of the port: weighted multi-vector QPS at recall@10 on one GPU.

    python -m coltt_tpu_torch.bench_cflat [--rows 1048576] [--seed 0]

The configuration of the JAX package's ``bench_cflat.py``: records of two
named vectors, a 768d ``semantic`` and a 256d ``title`` field, F8 codes,
cosine, each query scoring sum_f ratio_f * normalize(dist_f) with ratios
70 / 30 and one top-10 over the weighted sum. The rows are i.i.d.
gaussian, made on the card from ``--seed``, quantized there and handed,
as device tensors, to a ``MultiVectorStore`` through ``store/convert.py``
``multivec_store_from_arrays``.

Measured on the card, after a first (warm-up) call: the p50 of 5
synchronous 512-query batches and the queued QPS (``bench.time_dispatch``:
8 batches queued a round, median of 5 rounds after 2), and recall@10 of 64
queries against the exact f32 weighted sum over the f32 rows (TF32 off).
Prints one JSON line on stdout, with the card's name and power limit;
progress goes to stderr. Without a CUDA device it exits 1 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from coltt_tpu_torch.bench import card, log, time_dispatch
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization, dequantize, quantize
from coltt_tpu_torch.ops.topk import compute_recall
from coltt_tpu_torch.store.convert import multivec_store_from_arrays
from coltt_tpu_torch.store.multivec import MultiVectorStore

FIELDS = {"semantic": 768, "title": 256}
RATIOS = {"semantic": 70.0, "title": 30.0}
ROWS = 1 << 20
K = 10
BATCH = 512
DEPTH = 8
RECALL_QUERIES = 64
_TRUTH_BLOCK = 1 << 17


def make_rows(n: int, gen: torch.Generator) -> dict:
    """``{field: [n, D_f] f32}`` gaussian rows on ``gen``'s device."""
    return {f: torch.randn((n, d), generator=gen, device=gen.device)
            for f, d in FIELDS.items()}


def build_store(rows: dict, device) -> MultiVectorStore:
    """An F8 cosine store over ``rows`` (primary keys the row numbers),
    quantized on the rows' device and kept there."""
    codes, scale, sqnorm = {}, {}, {}
    for f, x in rows.items():
        codes[f], scale[f] = quantize(x, Quantization.F8)
        deq = dequantize(codes[f], scale[f])
        sqnorm[f] = (deq * deq).sum(dim=1)
        del deq
    n = next(iter(rows.values())).shape[0]
    return multivec_store_from_arrays(
        fields=FIELDS, metric=Metric.COSINE, quantization=Quantization.F8,
        codes=codes, scale=scale, sqnorm=sqnorm,
        valid=torch.ones(n, dtype=torch.bool, device=device),
        pk_to_slot={str(i): i for i in range(n)}, device=device)


def weighted_truth(queries: dict, rows_of, n: int, ratios=RATIOS,
                   k: int = K) -> np.ndarray:
    """Exact top-k ids of the f32 weighted cosine score (sum_f ratios[f] /
    100 * (1 + cos_f) * 50, the 0-100 scale) of ``queries {field: [Q,
    D_f]}`` over ``n`` rows; ``rows_of(field, lo, hi)`` gives an f32 row
    block. The products run in f32 (TF32 off on the card)."""
    qn = {f: F.normalize(q, dim=1) for f, q in queries.items()}
    best = None
    for lo in range(0, n, _TRUTH_BLOCK):
        hi = min(n, lo + _TRUTH_BLOCK)
        total = sum((1.0 + qn[f] @ F.normalize(rows_of(f, lo, hi), dim=1).t())
                    * (50.0 * ratios[f] / 100.0) for f in queries)
        v, i = torch.topk(total, k, dim=1)
        i = i + lo
        if best is not None:
            v, sel = torch.topk(torch.cat([best[0], v], 1), k, dim=1)
            i = torch.gather(torch.cat([best[1], i], 1), 1, sel)
        best = (v, i)
    return best[1].cpu().numpy()


def split(q: torch.Tensor) -> tuple:
    """A ``[Q, sum D_f]`` query block -> one view per field, in order."""
    return tuple(torch.split(q, list(FIELDS.values()), dim=1))


def dispatcher(store: MultiVectorStore, k: int = K):
    """``dispatch(q [Q, sum D_f]) -> (scores, slots)`` device tensors, not
    waited for: the store's weighted scan at the bench's ratios."""
    names = tuple(FIELDS)
    ratios = tuple(RATIOS[f] / 100.0 for f in names)
    return lambda q: store.search_tensors(names, split(q), ratios, k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_cflat: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    dev = card()
    log(f"device: {dev}")

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    rows = make_rows(args.rows, gen)
    store = build_store(rows, device)
    width = sum(FIELDS.values())
    q_batches = [torch.randn((BATCH, width), generator=gen, device=device)
                 for _ in range(DEPTH)]
    rq = torch.randn((RECALL_QUERIES, width), generator=gen, device=device)
    torch.cuda.synchronize()
    log(f"{args.rows} x {FIELDS} rows made and stored as F8: "
        f"{time.perf_counter() - t0:.1f} s")

    dispatch = dispatcher(store)
    warmup_s, p50_ms, qps, qps_rounds = time_dispatch(dispatch, q_batches)
    truth = weighted_truth(dict(zip(FIELDS, split(rq))),
                           lambda f, lo, hi: rows[f][lo:hi], args.rows)
    got = dispatch(rq)[1].cpu().numpy()
    recall = float(compute_recall(got, truth))
    log(f"recall@{K} vs the f32 weighted sum ({RECALL_QUERIES} queries): {recall:.4f}")
    print(json.dumps({
        "metric": f"CFLAT 2-field weighted search QPS on one GPU at recall@{K} "
                  f"({args.rows} x (768+256)d f8, ratios 70/30, batch={BATCH}, "
                  f"queued depth={DEPTH})",
        "value": round(qps, 1),
        "unit": "qps",
        "recall_at_10": round(recall, 4),
        "recall_queries": RECALL_QUERIES,
        "p50_batch_latency_ms": round(p50_ms, 3),
        "qps_rounds": [round(x, 1) for x in qps_rounds],
        "warmup_s": round(warmup_s, 2),
        "rows": args.rows,
        "seed": args.seed,
        "device": dev,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""HNSW bench of the port: batched graph search QPS at recall@10 on one GPU.

    python -m coltt_tpu_torch.bench_hnsw [--rows 1000000] [--dim 128]
        [--beam | --descent N | --refine EF] [--efsweep] [--mutate] [--seed 0]

The configuration of the JAX package's ``bench_hnsw.py`` (BASELINE config
#3: HNSW graph search, bf16 device graph, 1M vectors, batched queries):
cosine, ``HnswConfig(m=16, ef_construction=100, ef=128,
algorithm="heuristic")``, a cluster-mixture corpus (16,384 centres, sigma
0.35: the recipe, made on the card from ``--seed``, not the reference's
numpy draws), built by ``bulk_build_clustered`` (``--descent N``
NN-descent rounds, ``--refine EF`` one beam-refinement round at that ef:
``--refine 32`` is the engine's ``bulk_build_auto``) or, with ``--beam``,
by the beam builder ``bulk_build``.

Measured on the card: the build's rows/s (host clock, the host arrays
staged first), then 512-query batches at k=10: the p50 of synchronous
batches and the QPS of 8 batches a round (median of 5 rounds after 2),
recall@10 of 1,024 queries against the exact f32 scan (TF32 off), and the
same rounds with the device loops at their fixed hop count (no host check
of the exit condition) beside the default form, in turns, with their ids
compared. ``--efsweep`` sweeps the serving ef; ``--mutate`` times the
search while a thread inserts and removes. Prints one JSON line on stdout
with the card's name and power limit; progress goes to stderr. Without a
CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time

import numpy as np
import torch

from coltt_tpu_torch.bench import card, log, mixture_rows
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.topk import compute_recall, scan_neg_topk
from coltt_tpu_torch.store import hnsw
from coltt_tpu_torch.store.hnsw import HnswConfig, HnswIndex

ROWS = 1_000_000
DIM = 128
N_CENTERS = 16384
SIGMA = 0.35
K = 10
BATCH = 512
DEPTH = 8
WARM = 2
ROUNDS = 5
EVAL_QUERIES = 1024
CONFIG = HnswConfig(m=16, ef_construction=100, ef=128, algorithm="heuristic")


def make_corpus(n: int, dim: int, gen: torch.Generator):
    """``(rows [n, dim] f32, centres)`` of the mixture on ``gen``'s device."""
    centers = torch.randn((N_CENTERS, dim), generator=gen, device=gen.device)
    return mixture_rows(gen, centers, n, SIGMA), centers


def make_queries(m: int, centers: torch.Tensor, gen: torch.Generator) -> np.ndarray:
    """``m`` queries of the corpus' mixture, as host f32."""
    return mixture_rows(gen, centers, m, SIGMA).cpu().numpy()


def ground_truth(queries: np.ndarray, rows: torch.Tensor, k: int = K) -> np.ndarray:
    """Exact cosine top-k ids by an f32 scan of ``rows`` (TF32 off)."""
    sqn = (rows * rows).sum(dim=1)
    _, ids = scan_neg_topk(torch.from_numpy(queries).to(rows.device), rows, None,
                           sqn, None, k=k, metric=Metric.COSINE,
                           compute_dtype=torch.float32)
    return ids.cpu().numpy()


def build(vecs: np.ndarray, device, *, beam=False, descent=0, refine_ef=0,
          device_dtype=torch.bfloat16):
    """``(index, build seconds, builder name)``: the bench's index over
    host rows ``vecs``, built on ``device``."""
    idx = HnswIndex(vecs.shape[1], metric=Metric.COSINE, config=CONFIG,
                    device_dtype=device_dtype, device=device)
    t0 = time.perf_counter()
    if beam:
        idx.bulk_build(vecs, refine_rounds=1, batch_rows=4096)
        builder = "bulk_build(beam)"
    else:
        idx.bulk_build_clustered(vecs, descent_rounds=descent)
        if refine_ef:
            idx.beam_refine(rounds=1, ef=refine_ef, batch_rows=4096)
        builder = (f"bulk_build_clustered(descent={descent}"
                   + (f",refine_ef={refine_ef}" if refine_ef else "") + ")")
    return idx, time.perf_counter() - t0, builder


def search_rounds(idx: HnswIndex, q_batches, *, ef=None, warm=WARM, rounds=ROUNDS):
    """``(p50 ms of one batch, QPS median over rounds, QPS of each round)``:
    each round searches every batch in turn (a search returns host arrays,
    so batches do not overlap)."""
    lats, qps = [], []
    for r in range(warm + rounds):
        t_round = time.perf_counter()
        for q in q_batches:
            t0 = time.perf_counter()
            idx.search(q, K, ef=ef)
            lats.append(time.perf_counter() - t0)
        dt = time.perf_counter() - t_round
        if r >= warm:
            qps.append(len(q_batches) * q_batches[0].shape[0] / dt)
    lats = lats[warm * len(q_batches):]
    return statistics.median(lats) * 1e3, statistics.median(qps), qps


def loop_forms(idx: HnswIndex, q_batches, eval_q) -> dict:
    """The default loop form (an exit check every ``LOOP_CHECK_EVERY``
    hops) and the fixed hop count, timed in turns (default, fixed, fixed,
    default), with their ids and distances on ``eval_q`` compared."""
    default = hnsw.LOOP_CHECK_EVERY
    out = {"check_every": default, "rounds": []}
    try:
        results = {}
        for form in ("default", "fixed", "fixed", "default"):
            hnsw.LOOP_CHECK_EVERY = default if form == "default" else 0
            p50, qps, _ = search_rounds(idx, q_batches, warm=1, rounds=3)
            out["rounds"].append({"form": form, "p50_ms": round(p50, 3),
                                  "qps": round(qps, 1)})
            results.setdefault(form, idx.search(eval_q, K))
    finally:
        hnsw.LOOP_CHECK_EVERY = default
    (d0, i0), (d1, i1) = results["default"], results["fixed"]
    out["ids_equal"] = bool((i0 == i1).all())
    out["dists_equal"] = bool(np.array_equal(d0, d1))
    return out


def mutate_qps(idx: HnswIndex, q_batches, extra: np.ndarray, *, warm=WARM,
               rounds=ROUNDS) -> dict:
    """Search QPS while a thread inserts ``extra`` rows one by one and
    removes every third one (the dirty-row updates of the device cache)."""
    stop = threading.Event()
    inserted, errors = [], []

    def writer():
        try:
            i = 0
            while not stop.is_set() and i < len(extra):
                inserted.append(idx.insert(extra[i]))
                if i % 3 == 2:
                    idx.remove(inserted[-2])
                i += 1
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(e)

    t = threading.Thread(target=writer)
    t.start()
    try:
        p50, qps, _ = search_rounds(idx, q_batches, warm=warm, rounds=rounds)
    finally:
        stop.set()
        t.join()
    if errors:
        raise errors[0]
    return {"qps": qps, "p50_ms": p50, "inserts": len(inserted)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--beam", action="store_true")
    ap.add_argument("--descent", type=int, default=0)
    ap.add_argument("--refine", type=int, default=0)
    ap.add_argument("--efsweep", action="store_true")
    ap.add_argument("--mutate", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_hnsw: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    dev = card()
    log(f"device: {dev}")

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    rows, centers = make_corpus(args.rows, args.dim, gen)
    vecs = rows.cpu().numpy()
    eval_q = make_queries(EVAL_QUERIES, centers, gen)
    q_batches = [make_queries(BATCH, centers, gen) for _ in range(DEPTH)]
    gt = ground_truth(eval_q, rows)
    del rows
    torch.cuda.empty_cache()
    log(f"{args.rows} x {args.dim} mixture rows and ground truth: "
        f"{time.perf_counter() - t0:.1f} s")

    idx, build_s, builder = build(vecs, device, beam=args.beam,
                                  descent=args.descent, refine_ef=args.refine)
    log(f"{builder}: {build_s:.1f} s ({args.rows / build_s:.0f} rows/s)")

    t0 = time.perf_counter()
    idx.search(q_batches[0], K)
    warmup_s = time.perf_counter() - t0
    p50_ms, qps, qps_rounds = search_rounds(idx, q_batches)
    recall = float(compute_recall(idx.search(eval_q, K)[1], gt))
    log(f"p50 batch {p50_ms:.2f} ms; {qps:.0f} QPS; recall@{K} {recall:.4f}")
    forms = loop_forms(idx, q_batches, eval_q)
    log(f"loop forms: {forms}")

    ef_sweep = None
    if args.efsweep:
        ef_sweep = {}
        for ef in (64, 128, 256, 512):
            _, qps_ef, _ = search_rounds(idx, q_batches, ef=ef)
            rec_ef = float(compute_recall(idx.search(eval_q, K, ef=ef)[1], gt))
            log(f"ef={ef}: {qps_ef:.0f} QPS, recall@{K} {rec_ef:.4f}")
            ef_sweep[ef] = {"qps": round(qps_ef, 1), "recall_at_10": round(rec_ef, 4)}

    mutate = None
    if args.mutate:
        mutate = mutate_qps(idx, q_batches, make_queries(4096, centers, gen))
        log(f"interleaved mutate/search: {mutate}")

    print(json.dumps({
        "metric": f"HNSW bf16 QPS on one GPU at recall@{K} ({args.rows} x "
                  f"{args.dim}d mixture, ef={CONFIG.ef}, batch={BATCH})",
        "value": round(qps, 1),
        "unit": "qps",
        "recall_at_10": round(recall, 4),
        "p50_batch_latency_ms": round(p50_ms, 3),
        "qps_rounds": [round(x, 1) for x in qps_rounds],
        "warmup_s": round(warmup_s, 2),
        "build_seconds": round(build_s, 1),
        "build_rows_per_s": round(args.rows / build_s, 1),
        "builder": builder,
        "loop_forms": forms,
        "ef_sweep": ef_sweep,
        "mutate": mutate,
        "rows": args.rows,
        "dim": args.dim,
        "seed": args.seed,
        "device": dev,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

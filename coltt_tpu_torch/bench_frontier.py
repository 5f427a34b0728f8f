"""Selection frontier of the flagship index: QPS, latency and recall@10 per
``final`` on one GPU.

    python -m coltt_tpu_torch.bench_frontier [final ...]   # default: all seven

The counterpart of the JAX package's ``bench_frontier.py``, on the port's
bench machinery (:mod:`coltt_tpu_torch.bench`): ``bench.N_ROWS`` x
``bench.DIM`` cosine rows from ``bench.SEED``, the I8 index with a bf16
rerank copy (``bench.build_index``), searched with K1's int8 loop and a
k x 4 shortlist under each selection of the ``[Q, N/32]`` bin survivors
(``ops/fused_scan.py`` ``select_bins``; every name of
``fused_scan.FINALS`` but ``auto``, of which the port runs two paths:
slot2, and the exact top-k; the others are aliases of one of them, as
the module says). Per final:

- queued QPS (``bench.time_dispatch``: ``DEPTH`` 2048-query batches a
  round, the median of 5 rounds after 2 warm ones) and its rounds, and
  the p50 latency of a synchronous batch;
- recall@10 on 2048 queries against an f32 ``NONE`` index (TF32 off),
  and the share of ids equal to ``exact``'s at the same rank;
- the K1 launches of one search of those queries
  (``binmax_scan.launches_by``);
- the selection's own time (``selection_ms``): CUDA events around the
  selection alone, on the ``[Q, nb]`` keys of one K1 call over the 2048
  queries, the median of ``SELECT_REPS``. It is the wall time between
  the two events, host launch gaps included, not a device-busy time.

Prints one JSON line on stdout, with the card's name and power limit
(``nvidia-smi``); progress goes to stderr; writes no file. Without a CUDA
device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from coltt_tpu_torch import bench
from coltt_tpu_torch.ops import fused_scan as fs
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.ops.topk import compute_recall
from coltt_tpu_torch.parallel.dist_search import DistributedFlatIndex

FINALS = tuple(f for f in fs.FINALS if f != "auto")
DEPTH = 8
RECALL_QUERIES = 2048
SELECT_REPS = 20

log = bench.log


def k1_keys(idx: DistributedFlatIndex, queries: torch.Tensor):
    """``(keys, low_bits)``: the K1 keys of ``queries`` over the rows of a
    one-device index, made by its fused search's own scan step
    (``fused_scan.fused_scan_keys``), and the slice bits of the keys."""
    if idx.mesh is not None:
        raise ValueError("bench_frontier: needs an index on one device")
    inp = fs.fused_scan_keys(queries, idx.codes, idx.scale, idx.sqnorm,
                             idx.valid, metric=idx.metric,
                             compute_dtype=idx.compute_dtype)
    return inp["keys"], inp["sbits"]


def selection_ms(keys, low_bits: int, final: str, kk: int,
                 reps: int = SELECT_REPS) -> float:
    """Median ms between CUDA events around ``select_bins`` alone on
    ``keys``, after one warm call: the wall time of the selection's
    launches, host gaps between them included."""
    fs.select_bins(keys, kk, final, low_bits)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fs.select_bins(keys, kk, final, low_bits)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def frontier(idx: DistributedFlatIndex, q_batches, queries: np.ndarray,
             truth: np.ndarray, finals=FINALS, *, warm: int = bench.WARM,
             rounds: int = bench.ROUNDS):
    """Measure each of ``finals`` on the one-device index ``idx``:
    ``(records, detail)``. ``records[final]`` is the JSON record of the
    module docstring; ``detail[final]`` holds the search's ``ids`` on
    ``queries`` and the selection ``sel`` / ``pos`` on their K1 keys, and
    ``detail["exact"]`` is always there, for the comparisons."""
    k, oversample = bench.K, bench.OVERSAMPLE
    q_dev = torch.from_numpy(queries).to(idx.device)
    keys, low_bits = k1_keys(idx, q_dev)
    kk = min(k * oversample, keys.shape[1])
    records, detail = {}, {}
    for final in dict.fromkeys(("exact",) + tuple(finals)):
        before = dict(fs.binmax_scan.launches_by)
        _, ids = idx.search(queries, k, oversample=oversample, fused=True,
                            final=final)
        launches = {f"{c} {loop}": n - before.get((c, loop), 0)
                    for (c, loop), n in fs.binmax_scan.launches_by.items()
                    if n != before.get((c, loop), 0)}
        sel, pos, _ = fs.select_bins(keys, kk, final, low_bits)
        detail[final] = {"ids": ids, "sel": sel.cpu().numpy(),
                         "pos": pos.cpu().numpy()}
        if final not in finals:
            continue

        def dispatch(q, final=final):
            return idx.search_tensors(q, k, oversample=oversample, fused=True,
                                      final=final)

        log(f"[{final}]")
        warmup_s, p50_ms, qps, qps_rounds = bench.time_dispatch(
            dispatch, q_batches, warm=warm, rounds=rounds)
        records[final] = {
            "qps": qps,
            "qps_rounds": qps_rounds,
            "p50_batch_latency_ms": p50_ms,
            "recall_at_10": float(compute_recall(ids, truth)),
            "ids_equal_to_exact": float((ids == detail["exact"]["ids"]).mean()),
            "k1_launches_per_search": launches,
            "selection_ms": selection_ms(keys, low_bits, final, kk),
            "warmup_s": warmup_s,
        }
        log(f"[{final}] {json.dumps(records[final])}")
    return {f: records[f] for f in finals}, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("finals", nargs="*", metavar="final",
                    help=f"selections to measure, of {', '.join(FINALS)} "
                         f"(default: all seven)")
    args = ap.parse_args(argv)
    unknown = [f for f in args.finals if f not in FINALS]
    if unknown:
        ap.error(f"unknown finals {unknown}; choose from {', '.join(FINALS)}")
    finals = tuple(args.finals) or FINALS
    if not torch.cuda.is_available():
        print("bench_frontier: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    dev = bench.card()
    log(f"device: {dev}")

    rng = np.random.default_rng(bench.SEED)
    t0 = time.perf_counter()
    vecs = torch.from_numpy(
        rng.standard_normal((bench.N_ROWS, bench.DIM), dtype=np.float32)).to(device)
    idx = bench.build_index(vecs, device, unit_i8=False)
    gt_idx = DistributedFlatIndex(device, vecs, metric=Metric.COSINE,
                                  quantization=Quantization.NONE)
    del vecs
    q_batches = [
        torch.from_numpy(rng.standard_normal((bench.BATCH, bench.DIM),
                                             dtype=np.float32)).to(device)
        for _ in range(DEPTH)
    ]
    queries = rng.standard_normal((RECALL_QUERIES, bench.DIM), dtype=np.float32)
    truth = gt_idx.search(queries, bench.K)[1]
    del gt_idx
    torch.cuda.synchronize()
    log(f"data, index and ground truth ({RECALL_QUERIES} queries): "
        f"{time.perf_counter() - t0:.1f} s")

    records, _ = frontier(idx, q_batches, queries, truth, finals)
    print(json.dumps({
        "config": f"FLAT fused-i8 K1 + bf16 rerank, {idx.n} x {idx.dim}d "
                  f"cosine, k={bench.K}, oversample {bench.OVERSAMPLE}, "
                  f"batch {bench.BATCH}, queued depth {DEPTH}, one GPU",
        "methodology": f"QPS: median of {bench.ROUNDS} queued rounds after "
                       f"{bench.WARM} warm; recall@10 on {RECALL_QUERIES} "
                       f"queries vs an f32 exact scan (TF32 off); selection_ms: "
                       f"median of {SELECT_REPS} CUDA-event wall times of the "
                       f"selection alone on one K1 call's keys (host launch "
                       f"gaps included)",
        "finals": records,
        "seed": bench.SEED,
        "device": dev,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

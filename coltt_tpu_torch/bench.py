"""Flagship benchmark of the port: QPS at recall@10 on one GPU.

    python -m coltt_tpu_torch.bench             # fused int8 scan (K1)
    python -m coltt_tpu_torch.bench --unit-i8   # unit-norm int8 scan (K2)

The configuration of the JAX package's ``bench.py``: 1M x 768d cosine
rows, int8 codes with a bf16 rerank copy, the fused scan with
``final="approx"`` (an exact top-k over the bin survivors in the port),
a k x 4 shortlist reranked to k=10, 2048-query batches. ``--unit-i8``
serves the same rows from a unit-norm, global-scale int8 index through
K2 instead (selection "auto", i.e. slot2 at this size). As the JAX
package's bench, the index is built over a mesh of every visible card
(``make_mesh``): on one card that is the one-device path.

Measured on the card, after a first (warm-up) call:

- p50 batch latency: median of 5 synchronous batches (host clock; each
  ends in a device-to-host copy of the results);
- QPS: ``depth`` batches queued on the device, their results fetched
  after all were queued; the median of ``rounds`` such rounds after
  ``warm`` discarded ones;
- recall@10 on a dedicated 4096-query sample against an f32
  ``DistributedFlatIndex(quantization=NONE)`` exact scan (TF32 off);
- where the device time goes: one more queued round under
  ``torch.profiler``, giving the device's busy and idle share of the
  round's wall time and the device time of the costliest kernels.

Rows and queries come from ``np.random.default_rng(SEED)``. Prints
exactly one JSON line on stdout, with the card's name and power limit
(``nvidia-smi``); progress goes to stderr. Without a CUDA device it exits
1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from coltt_tpu_torch.ops import fused_scan as fs
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.ops.topk import compute_recall, fetch_scores_ids
from coltt_tpu_torch.parallel.dist_search import DistributedFlatIndex
from coltt_tpu_torch.parallel.mesh import make_mesh

N_ROWS = 1_000_000
DIM = 768
K = 10
BATCH = 2048
DEPTH = 16
WARM = 2
ROUNDS = 5
P50_BATCHES = 5
OVERSAMPLE = 4
FINAL = "approx"
RECALL_QUERIES = 4096
SEED = 0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_index(vectors, device, *, unit_i8: bool) -> DistributedFlatIndex:
    """The flagship index over ``vectors`` (numpy or a tensor), on a
    device or a mesh."""
    return DistributedFlatIndex(
        device, vectors, metric=Metric.COSINE, quantization=Quantization.I8,
        rerank_dtype=torch.bfloat16, unit_i8=unit_i8,
    )


def time_dispatch(dispatch, q_batches, *, warm: int = WARM, rounds: int = ROUNDS):
    """Time ``dispatch(queries) -> (scores, ids)`` (device tensors, not
    waited for) over ``q_batches``: ``(warm-up s, p50 ms of synchronous
    batches, queued QPS, the QPS of each round)``. A round queues every
    batch, then fetches every result; QPS is the median over ``rounds``
    after ``warm`` discarded rounds."""
    depth, batch = len(q_batches), q_batches[0].shape[0]
    t0 = time.perf_counter()
    fetch_scores_ids(*dispatch(q_batches[0]))
    warmup_s = time.perf_counter() - t0

    lats = []
    for i in range(P50_BATCHES):
        t0 = time.perf_counter()
        fetch_scores_ids(*dispatch(q_batches[i % depth]))
        lats.append(time.perf_counter() - t0)
    p50_ms = float(np.median(lats) * 1e3)

    qps_rounds = []
    for r in range(warm + rounds):
        t0 = time.perf_counter()
        outs = [dispatch(q) for q in q_batches]
        for out in outs:
            fetch_scores_ids(*out)
        dt = time.perf_counter() - t0
        if r >= warm:
            qps_rounds.append(depth * batch / dt)
    qps = float(np.median(qps_rounds))
    log(f"p50 sync batch latency {p50_ms:.2f} ms; queued QPS median of "
        f"{rounds}: {qps:.0f} (rounds {[round(x) for x in qps_rounds]})")
    return warmup_s, p50_ms, qps, qps_rounds


def mixture_rows(gen: torch.Generator, centers: torch.Tensor, n: int,
                 sigma: float, spectrum=None) -> torch.Tensor:
    """``n`` rows of a cluster mixture on ``gen``'s device: a uniformly
    drawn centre plus ``sigma`` times gaussian noise (scaled per dim by
    ``spectrum`` when given). The corpus recipe of the JAX package's
    ``bench_bq.py`` and ``bench_pq.py``: on i.i.d. gaussian rows, whose
    nearest neighbours are barely nearer than the rest, sign and product
    codes rank noise for any implementation."""
    asg = torch.randint(0, centers.shape[0], (n,), generator=gen, device=gen.device)
    noise = torch.randn((n, centers.shape[1]), generator=gen, device=gen.device)
    if spectrum is not None:
        noise = noise * spectrum
    return centers[asg] + sigma * noise


def merge_truth(best, queries: torch.Tensor, rows: torch.Tensor, offset: int,
                k: int = K):
    """Fold a slab of rows (global ids from ``offset``) into a running
    exact f32 cosine top-k of ``queries`` (``best = (values, ids)`` or
    None); the product runs in f32 (TF32 off on the card)."""
    qn = torch.nn.functional.normalize(queries, dim=1)
    for lo in range(0, rows.shape[0], 1 << 17):
        xb = torch.nn.functional.normalize(rows[lo:lo + (1 << 17)], dim=1)
        v, i = torch.topk(qn @ xb.t(), k, dim=1)
        i = i + offset + lo
        if best is not None:
            v, sel = torch.topk(torch.cat([best[0], v], 1), k, dim=1)
            i = torch.gather(torch.cat([best[1], i], 1), 1, sel)
        best = (v, i)
    return best


def run(idx: DistributedFlatIndex, gt_idx: DistributedFlatIndex,
        rng: np.random.Generator, *, batch: int = BATCH, depth: int = DEPTH,
        warm: int = WARM, rounds: int = ROUNDS,
        recall_queries: int = RECALL_QUERIES) -> dict:
    """Time the flagship search of ``idx`` (or of any other index, through
    the same fused search) and score its recall against the exact
    ``gt_idx``; returns the bench's record (without the card). Queries
    come from ``rng``."""
    dim, device = idx.dim, idx.device

    def dispatch(q):
        return idx.search_tensors(q, K, oversample=OVERSAMPLE, fused=True,
                                  final=FINAL)

    q_batches = [
        torch.from_numpy(rng.standard_normal((batch, dim), dtype=np.float32))
        .to(device) for _ in range(depth)
    ]
    warmup_s, p50_ms, qps, qps_rounds = time_dispatch(
        dispatch, q_batches, warm=warm, rounds=rounds)

    gq = rng.standard_normal((recall_queries, dim), dtype=np.float32)
    got, truth = [], []
    for i in range(0, recall_queries, batch):
        truth.append(gt_idx.search(gq[i:i + batch], K)[1])
        got.append(idx.search(gq[i:i + batch], K, oversample=OVERSAMPLE,
                              fused=True, final=FINAL)[1])
    recall = float(compute_recall(np.concatenate(got), np.concatenate(truth)))
    log(f"recall@{K} vs f32 ({recall_queries} queries): {recall:.4f}")

    rerank = " + bf16 rerank" if idx.rr_codes is not None else ""
    path = ("unit-i8 K2 + bf16 rerank, final=auto" if idx.unit_i8 else
            f"fused-{idx.quantization.name.lower()} K1{rerank}, final={FINAL}")
    cards = idx.mesh.shards if idx.mesh is not None else 1
    where = ((f"{cards} GPUs" if cards > 1 else "one GPU") if device.type == "cuda"
             else f"the {device.type}")
    return {
        "metric": f"FLAT {path}: QPS on {where} at recall@{K} "
                  f"({idx.n} x {dim}d, batch={batch}, queued depth={depth}, "
                  f"median of {rounds})",
        "value": round(qps, 1),
        "unit": "qps",
        "recall_at_10": round(recall, 4),
        "recall_queries": recall_queries,
        "qps_rounds": [round(x, 1) for x in qps_rounds],
        "p50_batch_latency_ms": round(p50_ms, 3),
        "p50_query_latency_ms": round(p50_ms / batch, 4),
        "warmup_s": round(warmup_s, 2),
        "unit_i8": idx.unit_i8,
        "quantization": idx.quantization.name,
        "final": "auto" if idx.unit_i8 else FINAL,
    }


def profile_round(run, top: int = 8) -> dict:
    """``run()`` once under ``torch.profiler``: wall ms (host clock),
    device-busy ms (the union of the kernels' and copies' device
    intervals), idle share, and device ms of the ``top`` costliest
    kernels by name. Needs a CUDA device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    busy_us, end, by_name = 0.0, -1.0, {}
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        # summed under the name's first 80 characters, the key printed
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_ms": round(wall_ms, 3),
        "device_busy_ms": round(busy_us / 1e3, 3),
        "device_idle_share": round(max(0.0, 1.0 - busy_us / 1e3 / wall_ms), 4),
        "device_ms_by_kernel": {name: round(us / 1e3, 3) for name, us in top},
    }


def device_profile(idx: DistributedFlatIndex, rng: np.random.Generator) -> dict:
    """One queued round of the flagship search under ``torch.profiler``
    (:func:`profile_round`). Needs a CUDA index."""
    q_batches = [
        torch.from_numpy(rng.standard_normal((BATCH, idx.dim), dtype=np.float32))
        .to(idx.device) for _ in range(DEPTH)
    ]

    def run():
        outs = [idx.search_tensors(q, K, oversample=OVERSAMPLE, fused=True,
                                   final=FINAL) for q in q_batches]
        for out in outs:
            fetch_scores_ids(*out)

    return profile_round(run)


def smi_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` prints
    them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def card() -> dict:
    """The device record of a result line, with :func:`smi_line`'s
    name and power limit."""
    name, power = (f.strip() for f in smi_line().split(","))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi_name": name,
            "power_limit": power}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--unit-i8", action="store_true",
                    help="serve from the unit-norm int8 index (K2)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    mesh = make_mesh(num_shards=torch.cuda.device_count())
    dev = card()
    log(f"device: {dev}; mesh {mesh}")

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    vecs = torch.from_numpy(
        rng.standard_normal((N_ROWS, DIM), dtype=np.float32)).to(device)
    log(f"data {N_ROWS} x {DIM} f32 from seed {SEED}: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    idx = build_index(vecs, mesh, unit_i8=args.unit_i8)
    gt_idx = DistributedFlatIndex(mesh, vecs, metric=Metric.COSINE,
                                  quantization=Quantization.NONE)
    del vecs
    torch.cuda.synchronize()
    log(f"ingest (index + f32 ground-truth index): "
        f"{time.perf_counter() - t0:.1f} s")

    fs.reset_launch_counts()
    record = run(idx, gt_idx, rng)
    record["kernel_launches"] = {"K1": fs.binmax_scan.launches,
                                 "K2": fs.binmax_scan_i8.launches}
    record["profile"] = device_profile(idx, rng)
    record["seed"] = SEED
    record["device"] = dev
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

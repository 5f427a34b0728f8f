"""What the shard path costs on one card: the flagship index cut into 1-8
shards of the same GPU.

    python -m coltt_tpu_torch.bench_scaling

The measured half of the JAX package's ``bench_scaling.py`` (its analytic
interconnect model is TPU-specific and has no counterpart here): the same
1,048,576 x 768d cosine rows, I8 codes with a bf16 rerank copy, searched
with K1 (``final="approx"``, a k x 4 shortlist per shard reranked to
k=10) at Q=2048, through meshes of 1 shard (the one-device bypass), 1
shard without the bypass (the shard body and the merge), and 2, 4 and 8
shards, every shard on ``cuda:0``. The total rows stay fixed, so what
moves is the shard path's own cost: a K1 launch and a selection per shard
and query block, a rerank per shard, and the merge of the ``[Q, k]``
partials.

For each mesh: queued QPS and p50 batch latency (``bench.time_dispatch``:
the median of rounds of 16 queued batches, each round's results fetched
after all were queued), K1 launches per search, the share of ids equal
to the one-shard bypass's, and the merge's device time (CUDA events,
median of 20, on partials of the search's shape). Rows and queries come
from ``np.random.default_rng(SEED)`` as in ``bench.py``. Prints one JSON
line on stdout with the card's name and power limit, and writes no file;
progress goes to stderr. Without a CUDA device it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from coltt_tpu_torch import bench
from coltt_tpu_torch.ops import fused_scan as fs
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.parallel.dist_search import DistributedFlatIndex, _merge_partials
from coltt_tpu_torch.parallel.mesh import make_mesh

N_ROWS = 1 << 20
DIM = 768
K = 10
Q = 2048
OVERSAMPLE = 4
DEPTH = 16
ROUNDS = 3
MERGE_REPS = 20
SEED = 0
# (name, shards, bypass_single)
MESHES = (("1-bypass", 1, True), ("1-no-bypass", 1, False), ("2", 2, False),
          ("4", 4, False), ("8", 8, False))


def merge_ms(shards: int, device: torch.device) -> float:
    """Device ms of one merge of ``shards`` ``[Q, k]`` partials (CUDA
    events, median of MERGE_REPS after a warm-up)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    parts = [(torch.randn((Q, K), generator=gen, device=device),
              torch.randint(0, N_ROWS // shards, (Q, K), generator=gen, device=device,
                            dtype=torch.int32)) for _ in range(shards)]
    local_n = N_ROWS // shards
    _merge_partials(parts, local_n, K, device)
    times = []
    for _ in range(MERGE_REPS):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _merge_partials(parts, local_n, K, device)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("bench_scaling: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    vecs = torch.from_numpy(rng.standard_normal((N_ROWS, DIM), dtype=np.float32)).to(device)
    q_batches = [torch.from_numpy(rng.standard_normal((Q, DIM), dtype=np.float32)).to(device)
                 for _ in range(DEPTH)]
    bench.log(f"data {N_ROWS} x {DIM} from seed {SEED}: {time.perf_counter() - t0:.1f} s")
    fs.load_kernels()
    results, base_ids = [], None
    for name, shards, bypass in MESHES:
        mesh = make_mesh(shards, devices=[device] * shards)
        idx = DistributedFlatIndex(mesh, vecs, quantization=Quantization.I8,
                                   rerank_dtype=torch.bfloat16)

        def dispatch(q, idx=idx, bypass=bypass):
            return idx.search_tensors(q, K, oversample=OVERSAMPLE, fused=True,
                                      final="approx", bypass_single=bypass)

        _, ids = dispatch(q_batches[0])
        ids = ids.cpu().numpy()
        base_ids = ids if base_ids is None else base_ids
        before = fs.binmax_scan.launches
        dispatch(q_batches[0])
        launches = fs.binmax_scan.launches - before
        _, p50, qps, qps_rounds = bench.time_dispatch(dispatch, q_batches, warm=1,
                                                      rounds=ROUNDS)
        rec = {"mesh": name, "shards": shards, "bypass_single": bypass,
               "rows_per_shard": idx.codes.local_n, "qps": qps,
               "qps_rounds": qps_rounds, "p50_batch_ms": p50,
               "k1_launches_per_search": launches,
               "merge_device_ms": None if shards == 1 and bypass else merge_ms(shards, device),
               "same_ids_as_bypass": float((ids == base_ids).mean())}
        bench.log(json.dumps(rec))
        results.append(rec)
        del idx
        torch.cuda.empty_cache()
    print(json.dumps({
        "metric": f"FLAT fused-i8 K1 + bf16 rerank on one GPU cut into shards: QPS "
                  f"({N_ROWS} x {DIM}d, batch={Q}, queued depth={DEPTH}, median of "
                  f"{ROUNDS}, k={K} x {OVERSAMPLE} shortlist per shard)",
        "meshes": results, "seed": SEED, "device": bench.card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

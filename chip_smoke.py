#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``coltt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from ``coltt_tpu_torch/csrc``, checks each
against its plain PyTorch version on the card, then drives every ported
path: the edge server over gRPC and the flagship flat index of ``python
-m coltt_tpu_torch.bench`` on the same 1M x 768d rows (phases 3-4), the
selection frontier of that index (4b), the same rows sharded over four
shards of the card (9, run right after 4b), BQ and PQ (5-6), CFLAT, the
experimental mode (7), core mode, the HNSW store and the root server (8a,
8b), and the quickstart (10).

Phases (each exits non-zero on failure):

0. card line (``nvidia-smi`` name and power limit) and versions;
1. kernel build: one ``nvcc`` per source, started together
   (``binmax_scan.cu``: K1's int8 loop and K2; ``binmax_scan_float.cu``:
   K1's float-code loops), with each build's time and every kernel's
   registers and spills;
2. K1 against its plain version, on each of its loops: int8 codes
   (tensor cores, s8), f8 / bf16 codes and f32 codes under
   ``compute_dtype=bf16`` (tensor cores, bf16 operands), f32 codes and f8 /
   bf16 codes under ``compute_dtype=f32`` (CUDA cores, exact f32). Small
   shapes (planted rows, tombstones, zero-dot winners, all-invalid,
   Q=520), the tiling edges (Q in {1, 33, 520} unpadded, ragged against
   the query tiles; chunk in {2048, 4096}; D up to 6144, resident and
   streamed query tiles; for int8 every dot negative) and the serving
   shape (Q in {8, 2048}, N=1,048,576, D=768). int8 keys must be
   bit-identical; float keys within 1e-4 of the bias (the f32 sum over D
   runs in another order), with identical live bins, and the top-40 ids
   selected from them must overlap >= 39/40 per query. Median times by
   CUDA events, after a warm-up, taken in turns: the plain version, the
   kernel and the library yardstick, one PyTorch call of the same
   [Q, D] x [D, N] product that no path of the port calls
   (``torch._int_mm`` for int8 codes, a bf16 ``torch.matmul`` for bf16
   operands, the codes widened to bf16 before the timing, and an f32
   ``torch.matmul`` with TF32 off for exact f32). Each serving line also
   gives the bound (the larger of the bytes the function must move over
   3.35 TB/s and its operations over the peak rate of their type: 1,979
   TOP/s int8, 989 TFLOP/s bf16, 67 TFLOP/s f32) and the kernel's share
   of it;
2b. K2 against its plain version: small shapes (planted rows, dead bins,
   D=2048 at the packing's overflow edge, Q=520), the same tiling edges
   up to D=2048 and the serving shape (Q in {8, 2048}, N=1,003,520 -- 1M rows padded
   to 4096 -- D=768). Keys must be bit-identical; times, yardstick and
   bound as in phase 2;
3. the edge server end to end: recall@10 of the high_resource (K1) and
   the plain exact SearchBatch against f32 ground truth computed on the
   card with TF32 off; K1's must be no more than 0.01 below the plain
   path's. K1's launch count must rise during the high_resource search.
4. the flat index at 1M x 768d on phase 3's rows, queries and ground
   truth: the I8 + bf16-rerank index searched with K1 and
   ``final="approx"`` (the bench's configuration) and ``"slot2"``, the
   unit-norm int8 index searched through K2 (``auto``, i.e. slot2), the
   F8 + bf16-rerank and the BF16 index through K1's bf16 loop and the
   f32 (NONE) index through its exact-f32 loop (``approx``). Each
   recall@10 must be >= 0.95 and >= phase 3's K1 recall - 0.01, no row
   of the padding may come back and scores must descend; each search
   must raise the count of its own kernel and loop, and a queued search
   of each index run under ``torch.cuda.set_sync_debug_mode("error")``
   must not wait for the device. Then a short run of the bench (depth 16,
   fewer rounds) on the I8, unit-i8, F8 and BF16 indexes prints the
   bench's JSON line for each, and one queued round of the F8 index runs
   under ``torch.profiler`` (device busy and idle share, device ms by
   kernel).
4b. the selection frontier (``python -m coltt_tpu_torch.bench_frontier``'s
   measurement) on phase 4's I8 + bf16 index, queries and ground truth:
   for each of ``exact``, ``approx``, ``approx2``, ``slot2``, ``slot2t``,
   ``slot2c`` and ``slot2a`` (the port runs two paths, the exact top-k
   and slot2; the others are aliases, as ``ops/fused_scan.py`` says),
   queued QPS (depth 8 x 2048 queries, median of 3 rounds after 1 warm),
   p50, recall@10, the share of ids equal to ``exact``'s and the
   selection's CUDA-event wall ms (on one K1 call's keys, made by the
   search's own scan step, median of 20), beside the card's name and
   power limit. Every recall@10 must be >= 0.95; ``slot2t`` / ``slot2c``
   / ``slot2a`` must return ``slot2``'s ids; ``approx`` and ``approx2``
   must select ``exact``'s key values at every rank, and return
   ``exact``'s ids on every query whose selected bins are ``exact``'s
   (elsewhere the bins differ by a tie of equal keys, whose order
   ``torch.topk`` does not fix). K1 must launch there, K2 not.

5. BQ at 1,048,576 x 768 (the corpus recipe of ``bench_bq.py``: 16,384
   centres, sigma 0.35, made on the card): the Hamming shortlist of the
   +-1 form (``torch._int_mm``) must equal, rank for rank, the plain
   popcount over the same packed words, ids included with the exact
   per-block keep; with the capped keep a rerank follows, the distances
   at every rank, each id a distinct row at its distance;
   ``DistributedFlatIndex.from_bq_codes`` with a bf16 rerank copy at oversample 16 must reach
   recall@10 >= 0.95 against the f32 ground truth (TF32 off), without a
   copy its recall is printed; both report p50 and queued QPS. Then an
   edge BQ collection over gRPC: BulkIndex, SearchBatch with and without
   high_resource (recall >= 0.95), a tag-filtered Search, Flush /
   Release / Load returning the same ids.
6. PQ at 1,048,576 x 768 (``bench_pq.py``'s recipe: the same mixture
   with an i^-0.5 per-dim decay): an edge PQ collection over gRPC (M=96,
   K=256, OPQ 4, f8 cache), BulkIndex, the first search training the
   codebook; SearchBatch high_resource (K1's bf16 loop over the f8
   cache, a shortlist of 40, the exact-reconstruction rerank; K1's
   (f8, bf16-wgmma) count must rise) and plain; a ``pq_cache=False``
   store over the same codes (ADC). Each path's recall@10 against exact
   ADC (every row reconstructed in f32, an f32 product with TF32 off)
   must be >= 0.95; recall against the f32 ground truth is printed. K1's
   ``edge_pq`` count is read after the edge SearchBatches alone; the
   store-level searches after them (QPS, p50, one round of high_resource
   and one of ADC searches under ``torch.profiler``) count their own.
   The collection's snapshot loaded with ``pq_host_codes`` (the code table
   on the host, the rerank's rows gathered there) is searched as
   high_resource and held to the same recall limit. Flush / Release /
   Load (the cache rebuild timed) must return the same ids.
7. CFLAT (experimental mode). The store at ``bench_cflat.py``'s size:
   1,048,576 records of a 768d and a 256d gaussian field made on the card,
   F8, cosine, filled through ``multivec_store_from_arrays``;
   ``search_batch`` at Q=512, ratios 70/30: recall@10 >= 0.95 against the
   f32 weighted sum over the dequantized codes (TF32 off; recall against
   the f32 rows printed), no slot past the records, descending scores, a
   single ``search`` equal to its batch row; queued QPS (depth 8) and p50,
   one queued round under ``torch.profiler`` (device ms of the products,
   the selection and the elementwise passes), and one field's product
   timed in both forms (bf16 operands widened to f32, and
   ``torch.mm(..., out_dtype=float32)``). Then the experimental server:
   two 768d Vector fields and a tag, F8, 262,144 records through BulkIndex
   in 65,536-row RPCs; VectorSearchBatch recall@10 >= 0.95 against the
   dequantized weighted sum, VectorSearch equal to its batch row, an
   ``include_or_not=false`` field equal to leaving it out, an Index delete
   gone from every later result, Flush / Release / Load returning the same
   ids, and VectorSearchBatch p50 and QPS. CFLAT launches neither K1 nor
   K2 (its weighted sum needs every field's score of a row first); both
   counts must read 0 after the phase.

8. core mode (no kernel of ours runs there: the HNSW search and builders
   are torch ops). 8a, the store: ``bench_hnsw.py``'s recipe at
   1,000,000 x 128 (16,384 centres, sigma 0.35, made on the card), cosine,
   ``HnswConfig(m=16, ef_construction=100, ef=128, heuristic)``, bf16
   device graph, built by ``bulk_build_auto`` (timed as rows/s); search
   in batches of 512 at k=10: recall@10 >= 0.90 against the f32 scan
   (TF32 off), finite ascending distances, a single search equal to its
   batch row, queued QPS and p50, the loop forms (an exit check every
   ``LOOP_CHECK_EVERY`` hops against the fixed hop count, in turns, ids
   and distances equal), one round under ``torch.profiler`` (device busy
   and idle share, device ms by part: products, gathers, selections,
   elementwise, copies); removed slots never come back; searches with a
   thread inserting and removing raise nothing and keep recall@10 >= 0.90
   against the live rows. 8b, the server: ``--mode root`` in process,
   f32 graph, 131,072 x 128 rows in one BulkInsert (rows/s), then
   VectorSearchBatch Q=512 recall@10 >= 0.90; the server stops without a
   snapshot (as a crash: no snapshot, no hint) and a new one rebuilds the
   collection from the KV commit log, returning the same ids and scores;
   VectorSearchBatch p50; 2,000 one-by-one Inserts (rows/s);
   VectorSearch equal to its batch row; FilterSearch and HybridSearch on
   a tag return only its rows; Update and Delete show in later results;
   CompareDist of a vector with itself gives 100; Release + Load return
   the same ids. K1's and K2's counts must read 0 after the phase.

9. the sharded paths, run right after phase 4b on phase 4's rows (the flagship
   collection as a multi-GPU deployment cuts it, on one card: four
   shards, every one on ``cuda:0``). 9a: the I8 + bf16 and unit-i8
   indexes over the 4-shard mesh and the I8 index over a 1-shard mesh.
   K1 per shard without a rerank must give the ids of the one-device K1
   scan of the same rows (the 4-shard layout's rows, so K1's bins are the
   same) at every rank, ties aside; with the bf16 rerank (K1 per shard),
   and unit-i8 (K2 per shard, one global scale), recall@10 must be no
   lower than phase 4's; the 1-shard mesh without the bypass must equal
   the bypass; K1's and K2's launches a search must be a multiple of the
   shards. At 262,144 rows, 4 shards against one device: the BQ index
   (no rerank copy; ids equal ties aside), a PQ-cache store searched
   through K1 (equal), its exact rerank with the codes on the device and
   on the host (equal to each other, >= 0.95 of the one-device rerank's
   ids), and CFLAT (equal within 1e-4). 9b: an ``EdgeEngine`` over the
   4-shard mesh checkpointing to an ``S3ObjectStore`` on
   ``tests/fake_s3.py`` in this process: the 1M rows indexed, the plain
   SearchBatch ids equal phase 3's ties aside, high_resource recall@10
   >= phase 3's - 0.001, a filtered Search inside its tag, Flush ->
   Release -> Load through S3 (bytes and MB/s printed) giving the same
   ids. Then QPS and p50 of the flagship search on 1 shard, 1 shard
   without the bypass and 4 shards. 9c: two processes on ``cuda:0`` over
   gloo, each placing its half of the rows on its two shards, and one
   process over NCCL, each under a timeout (``chip_smoke.py
   --shard-worker``): each must return 9a's 4-shard K1 result. The one-
   device references are searched before the counts are set to 0; 9a
   and 9b count as ``sharded``; both kernels must launch there.
10. the quickstart (``python -m coltt_tpu_torch.quickstart``) on the
   card: the edge, core and experimental engines end to end, in seconds.

Each path's launch counts are set to 0 just before it is driven and
read just after.
Every number printed is this run's, on the card named in phase 0. The
second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

SEED = 0
N_ROWS = 1_000_000
DIM = 768
K = 10
BULK_ROWS = 20_000
QUERIES = 2048
TAGS = 8
REPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}  # dense
SERVING_N = 1 << 20  # the store's capacity at 1M rows
INDEX_N = 1_003_520  # the flat index's rows at 1M: padded to 4096
OVERSAMPLE = 4
BQ_OVERSAMPLE = 16  # the BQ index's shortlist: k x 16
CFLAT_N = 1 << 20  # phase 7's store: bench_cflat's 1,048,576 records
CFLAT_Q = 512
GRPC_CFLAT_N = 262_144  # phase 7's experimental collection, ingested over gRPC
GRPC_CFLAT_CHUNK = 65_536
CORE_N = 1_000_000  # phase 8a's HNSW store: bench_hnsw's size
CORE_DIM = 128
CORE_Q = 512
CORE_DEPTH = 8
CORE_GRPC_N = 131_072  # phase 8b's root-mode collection, through BulkInsert
CORE_INSERTS = 1000
SHARDS = 4  # phase 9's mesh: four shards of the one card
SHARD_N = 262_144  # phase 9a's BQ, PQ-cache and CFLAT checks
SHARD_WORKER_TIMEOUT = 240  # each phase 9c worker process, seconds
K1_EDGE_DIMS = (128, 768, 2048, 3072, 6144)  # int8 codes: any D % 128 == 0
K2_EDGE_DIMS = (128, 768, 2048)  # K2 stops at D=2048 (its packed key)
K1_SOURCES = {"int8-wgmma": "coltt_tpu_torch/csrc/binmax_scan.cu",
              "bf16-wgmma": "coltt_tpu_torch/csrc/binmax_scan_float.cu",
              "f32-simt": "coltt_tpu_torch/csrc/binmax_scan_float.cu"}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def timed(*fns, reps=REPS):
    """Median ms of each function, warmed up, measured in turns on one
    card."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for t, fn in zip(times, fns):
            t.append(cuda_ms(fn))
    return [statistics.median(t) for t in times]


def bound(q, codes, out, *, ops_type, extra_bytes=0):
    """(bound ms, what bounds it) of a scan of ``q`` against ``codes``
    writing ``out``: each input read once and the output written once at
    the card's memory rate, against 2*Q*N*D operations at the peak rate
    of ``ops_type``."""
    moved = (q.numel() * q.element_size() + codes.numel() * codes.element_size()
             + extra_bytes + out.numel() * out.element_size())
    ops = 2 * q.shape[0] * codes.shape[0] * codes.shape[1]
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[ops_type] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def int_mm_yardstick(q, codes):
    """One ``torch._int_mm`` of the same product (cuBLASLt needs M > 16:
    fewer query rows are zero-padded to 32 before the timing)."""
    import torch

    if q.shape[0] <= 16:
        q = torch.cat([q, q.new_zeros((32 - q.shape[0], q.shape[1]))])
    ct = codes.t()
    return lambda: torch._int_mm(q, ct)


def serving_record(what, err, ms, plain_ms, library_ms, bound_ms, bound_by):
    share = bound_ms / ms
    log(f"{what}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
        f"{'n/a' if library_ms is None else f'{library_ms:.3f} ms'}, bound "
        f"{bound_ms:.3f} ms ({bound_by}), share of bound {share:.3f}, max key "
        f"err {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": share}


def tiling_edges(pair, gen, what, dims):
    """The int8 loop's tiling edges: Q in {1, 33, 520} (unpadded: ragged
    against the 32 / 64 / 128-query tiles), chunk in {2048, 4096}, each D
    of ``dims``, on random codes, then every dot negative. At D=2048 the
    128-query tile streams through the ring beside the codes, at 3072 the
    64-query one too, at 6144 all three. ``pair(q, codes, chunk, what)``
    launches the kernel and holds it to its plain version."""
    import torch

    dev = torch.device("cuda")
    for d in dims:
        for chunk in (2048, 4096):
            n = 8192 if chunk == 4096 else 6144
            codes = torch.randint(-127, 128, (n, d), device=dev, dtype=torch.int8,
                                  generator=gen)
            for nq in (1, 33, 520):
                q = torch.randint(-127, 128, (nq, d), device=dev, dtype=torch.int8,
                                  generator=gen)
                pair(q, codes, chunk, f"{what} Q={nq} chunk={chunk} D={d}")
    codes = torch.randint(0, 128, (8192, 768), device=dev, dtype=torch.int8,
                          generator=gen)
    q = -torch.randint(1, 128, (70, 768), device=dev, dtype=torch.int8, generator=gen)
    got = pair(q, codes, 4096, f"{what} all-negative dots")
    check(bool((got < 0).all()), f"{what}: all-negative dots gave a non-negative key")


# -- phase 0 / 1 ---------------------------------------------------------------

def phase_card():
    import torch
    from coltt_tpu_torch.bench import smi_line
    from coltt_tpu_torch.ops.native import nvcc_path

    log(smi_line())

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc: {nvcc} "
        f"device {torch.cuda.get_device_name(0)}")


def phase_build():
    import re

    from coltt_tpu_torch.ops import fused_scan as fs

    t0 = time.perf_counter()
    libs = fs.load_kernels()  # builds in parallel, binds every entry point
    log(f"[build] K1 + K2 libraries ready in {time.perf_counter() - t0:.2f} s "
        f"(one nvcc per source, in parallel)")
    for lib in libs.values():
        entries = re.findall(
            r"entry function '\S*?\d\d(binmax_scan_\w+?_kernel\w*?)EE?v\S*'.*?"
            r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?Used (\d+) registers",
            lib.build_log, flags=re.S)
        log(f"[build] {os.path.basename(lib.source)}: nvcc {lib.build_seconds:.2f} s, "
            f"{len(entries)} kernels")
        for name, stores, loads, regs in entries:
            log(f"[build]   {name}: {regs} registers, spill {stores}/{loads} bytes")


# -- phase 2 -------------------------------------------------------------------

def _select(keys, chunk, k):
    """Top-k bin survivors -> (masked values f32, row ids), as the wrapper."""
    import torch

    nsl = chunk // 128
    fsel, pos = torch.topk(keys.view(torch.float32), k, dim=1)
    sel = fsel.view(torch.int32)
    ids = (pos // 128) * chunk + (sel & (nsl - 1)).long() * 128 + pos % 128
    return (sel & -nsl).view(torch.float32), ids


def _compare_keys(got, want, bias, chunk, exact, what):
    """Kernel vs plain keys; returns max |difference| of the key values."""
    import torch

    nsl = chunk // 128
    gv = (got & -nsl).view(torch.float32)
    wv = (want & -nsl).view(torch.float32)
    live = want > 0
    check(torch.equal(got > 0, live), f"{what}: valid/tombstone keys differ")
    err = (gv - wv)[live].abs().max().item() if live.any() else 0.0
    if exact:
        check(torch.equal(got, want), f"{what}: int8 keys not bit-identical "
              f"(max value diff {err})")
        return err
    tol = 1e-4 * bias
    check(err <= tol, f"{what}: key values differ by {err} > {tol}")
    kk = min(40, got.shape[1])
    gsv, gid = _select(got, chunk, kk)
    wsv, wid = _select(want, chunk, kk)
    for r in range(got.shape[0]):
        common = len(set(gid[r].tolist()) & set(wid[r].tolist()))
        check(common >= kk - 1, f"{what}: query {r} top-{kk} overlap {common}")
    sdiff = (gsv - wsv).abs().max().item()
    check(sdiff <= tol, f"{what}: top-{kk} values differ by {sdiff} > {tol}")
    return err


def _store_tensors(x, dtype):
    """A dense store's state from f32 rows: (codes, scale, sqnorm)."""
    import torch
    from coltt_tpu_torch.ops.quant import Quantization, dequantize, quantize

    quant = {torch.int8: Quantization.I8, torch.float8_e4m3fn: Quantization.F8,
             torch.bfloat16: Quantization.BF16,
             torch.float32: Quantization.NONE}[dtype]
    codes, scale = quantize(x, quant)
    deq = dequantize(codes, scale)
    return codes, scale, (deq * deq).sum(dim=1)


# (code dtype, compute dtype) of each K1 loop's serving line: int8 codes;
# f8, bf16 and f32 codes on bf16 operands; f32 codes on exact f32
_SERVING_CASES = ("int8", "f8", "bf16", "f32-bf16", "f32")


def _k1_cases():
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    return {"int8": (torch.int8, bf), "f8": (torch.float8_e4m3fn, bf),
            "bf16": (bf, bf), "f32-bf16": (f32, bf), "f32": (f32, f32),
            "f8-f32": (torch.float8_e4m3fn, f32), "bf16-f32": (bf, f32)}


def library_yardstick(q, codes, round_bf16):
    """One PyTorch call of K1's [Q, D] x [D, N] product on the same
    inputs: ``torch._int_mm`` for int8 codes, a bf16 ``torch.matmul`` for
    bf16 operands (codes widened to bf16 here, before the timing), an f32
    ``torch.matmul`` (TF32 off) for exact f32."""
    import torch

    if codes.dtype == torch.int8:
        return int_mm_yardstick(q, codes)
    if round_bf16:
        qb = q.to(torch.bfloat16)
        cb = codes if codes.dtype == torch.bfloat16 else codes.to(torch.bfloat16)
        return lambda: torch.matmul(qb, cb.t())
    ct = codes.to(torch.float32).t()
    return lambda: torch.matmul(q, ct)


def phase_kernels():
    """K1 vs its plain version on each loop; returns the serving-shape
    records (one per code dtype, loop and Q)."""
    import torch
    from coltt_tpu_torch.ops import fused_scan as fs
    from coltt_tpu_torch.ops.distance import Metric
    from coltt_tpu_torch.ops.topk import scan_topk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cases = _k1_cases()

    def k1_pair(q, codes, scale, sqnorm, valid, what, round_bf16, unpadded=False):
        inp = fs.scan_inputs(q, codes, scale, sqnorm, valid, metric=Metric.COSINE)
        chunk = fs.chunk_for(codes.shape[0])
        qk = inp["queries"][:q.shape[0]].contiguous() if unpadded else inp["queries"]
        args = (qk, codes, inp["rowmul"], inp["rowadd"])
        kw = dict(chunk=chunk, round_bf16=round_bf16)
        got = fs.binmax_scan(*args, **kw)
        torch.cuda.synchronize()
        want = fs.binmax_scan_ref(*args, **kw)
        err = _compare_keys(got, want, float(inp["bias"]), chunk,
                            codes.dtype == torch.int8, what)
        return args, kw, err

    # small shapes: the cases of the reference's kernel tests, on every loop
    n, d = 8192, 256
    x = torch.randn(n, d, device=dev, generator=gen)
    q = torch.randn(520, d, device=dev, generator=gen)
    planted = [17, 32 * 5 + 3, 32 * 20, 32 * 40 + 99, 32 * 60 + 1]
    xp = x.clone()
    for j, slot in enumerate(planted):
        xp[slot] = q[0] * (1.0 + 0.01 * j)
    for case, (dt, cdt) in cases.items():
        codes, scale, sqnorm = _store_tensors(xp, dt)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[::7] = False
        valid[planted] = True
        k1_pair(q, codes, scale, sqnorm, valid, f"small {case} Q=520",
                cdt == torch.bfloat16)
        kw = dict(k=5, compute_dtype=cdt)
        _, ids = fs.fused_scan_neg_topk(q[:3], codes, scale, sqnorm, valid, **kw)
        check(set(ids[0].tolist()) == set(planted), f"planted rows lost ({case})")
        # tombstone the self-match of a stored row
        tv = torch.ones(n, dtype=torch.bool, device=dev)
        tv[7] = False
        _, ids = fs.fused_scan_neg_topk(xp[7:8], codes, scale, sqnorm, tv, **kw)
        check(7 not in ids[0].tolist(), f"tombstoned row returned ({case})")
        negd, _ = fs.fused_scan_neg_topk(
            xp[:2], codes, scale, sqnorm,
            torch.zeros(n, dtype=torch.bool, device=dev), **kw)
        check(bool(torch.isneginf(negd).all()), f"all-invalid store scored ({case})")
        # Q=520: top-1 of K1 vs the plain exact scan
        _, i_fused = fs.fused_scan_neg_topk(q, codes, scale, sqnorm, valid, k=1,
                                            compute_dtype=cdt)
        _, i_exact = scan_topk(q, codes, scale, sqnorm, valid, k=1)
        match = (i_fused[:, 0] == i_exact[:, 0]).float().mean().item()
        check(match > 0.95, f"Q=520 top-1 agreement {match} ({case})")
    # zero-dot winners: every winner scores exactly 0, the rest negative
    zq = torch.zeros(1, 128, device=dev)
    zq[0, 0] = 1.0
    zx = torch.zeros(2048, 128, device=dev)
    zx[:, 0] = -0.5
    zx[:, 1] = 1.0
    zplant = [3, 32 + 7, 5 * 32 + 11, 900, 2047]
    zx[zplant, 0] = 0.0
    for cdt in (torch.float32, torch.bfloat16):
        k1_pair(zq, zx, None, (zx * zx).sum(1), None, f"zero-dot {cdt}",
                cdt == torch.bfloat16)
        scores, ids = fs.fused_scan_topk(zq, zx, None, (zx * zx).sum(1), None,
                                         k=len(zplant), compute_dtype=cdt)
        check(set(ids[0].tolist()) == set(zplant), "zero-dot winners lost their ids")
        check(bool(((scores - 50.0).abs() < 1e-3).all()), "zero-dot scores != 50")
    log(f"[kernels] small shapes: planted, tombstones, zero-dot, all-invalid, "
        f"Q=520 ok for {', '.join(cases)}")

    def raw_pair(q, codes, chunk, what):
        n = codes.shape[0]
        rowmul = torch.rand(n, device=dev, generator=gen) + 0.5
        rowadd = torch.randn(n, device=dev, generator=gen)
        kw = dict(chunk=chunk, round_bf16=False)
        got = fs.binmax_scan(q, codes, rowmul, rowadd, **kw)
        torch.cuda.synchronize()
        want = fs.binmax_scan_ref(q, codes, rowmul, rowadd, **kw)
        check(torch.equal(got, want), f"{what}: int8 keys not bit-identical")
        return got

    tiling_edges(raw_pair, gen, "K1 int8", K1_EDGE_DIMS)
    log(f"[kernels] int8 tiling edges: Q in {{1, 33, 520}} x chunk in {{2048, 4096}} "
        f"x D in {K1_EDGE_DIMS}, all-negative dots: keys bit-identical")
    for case, dims in (("f8", K1_EDGE_DIMS), ("bf16", K1_EDGE_DIMS),
                       ("f32-bf16", K1_EDGE_DIMS), ("f32", (128, 768, 2048)),
                       ("f8-f32", (128, 768)), ("bf16-f32", (128, 768))):
        dt, cdt = cases[case]
        for d in dims:
            for chunk in (2048, 4096):
                n = 8192 if chunk == 4096 else 6144
                x = torch.randn(n, d, device=dev, generator=gen)
                codes, scale, sqnorm = _store_tensors(x, dt)
                valid = torch.rand(n, device=dev, generator=gen) > 0.2
                for nq in (1, 33, 520):
                    q = torch.randn(nq, d, device=dev, generator=gen)
                    k1_pair(q, codes, scale, sqnorm, valid,
                            f"K1 {case} Q={nq} chunk={chunk} D={d}",
                            cdt == torch.bfloat16, unpadded=True)
        log(f"[kernels] {case} tiling edges: Q in {{1, 33, 520}} x chunk in "
            f"{{2048, 4096}} x D in {dims}: live bins identical, keys within "
            f"1e-4 of the bias, top-40 overlap >= 39")

    # serving shape
    n, d = SERVING_N, DIM
    x = torch.randn(n, d, device=dev, generator=gen)
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    valid[:N_ROWS] = True  # the padding past the data is tombstoned
    records = []
    for case in _SERVING_CASES:
        dt, cdt = cases[case]
        round_bf16 = cdt == torch.bfloat16
        codes, scale, sqnorm = _store_tensors(x, dt)
        loop = fs.k1_loop(dt, round_bf16)
        for nq in (8, QUERIES):
            q = torch.randn(nq, d, device=dev, generator=gen)
            what = f"[kernels] serving {case} ({loop}) Q={nq}"
            args, kw, err = k1_pair(q, codes, scale, sqnorm, valid, what, round_bf16)
            plain_ms, ms, library_ms = timed(
                lambda: fs.binmax_scan_ref(*args, **kw),
                lambda: fs.binmax_scan(*args, **kw),
                library_yardstick(args[0], codes, round_bf16))
            out = fs.binmax_scan(*args, **kw)
            ops_type = "int8" if dt == torch.int8 else ("bf16" if round_bf16 else "f32")
            bound_ms, bound_by = bound(args[0], codes, out, ops_type=ops_type,
                                       extra_bytes=2 * 4 * codes.shape[0])
            rec = serving_record(what, err, ms, plain_ms, library_ms, bound_ms, bound_by)
            _, qtile, stream = fs.k1_plan(dt, round_bf16, args[0].shape[0], d)
            records.append({"codes": str(dt).removeprefix("torch."), "loop": loop,
                            "source": K1_SOURCES[loop], "q": nq, "qtile": qtile,
                            "stream_queries": stream, **rec})
            del out
            torch.cuda.empty_cache()
        del codes, scale, sqnorm
    torch.cuda.empty_cache()
    return records


# -- phase 2b ------------------------------------------------------------------

def _unit_index(x):
    import torch
    from coltt_tpu_torch.ops.quant import Quantization
    from coltt_tpu_torch.parallel.dist_search import DistributedFlatIndex

    return DistributedFlatIndex(x.device, x, quantization=Quantization.I8,
                                rerank_dtype=torch.bfloat16, unit_i8=True)


def phase_k2():
    """K2 vs its plain version; returns the serving-shape Q=2048 record."""
    import torch
    from coltt_tpu_torch.ops import fused_scan as fs
    from coltt_tpu_torch.ops.distance import quantize_queries_i8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)

    def k2_pair(qi, codes, chunk, what):
        got = fs.binmax_scan_i8(qi, codes, chunk=chunk)
        torch.cuda.synchronize()
        want = fs.binmax_scan_i8_ref(qi, codes, chunk=chunk)
        err = (got.long() - want.long()).abs().max().item()
        check(torch.equal(got, want), f"{what}: K2 keys not bit-identical "
              f"(max diff {err})")
        return got, err

    # small shapes: planted rows, dead bins, Q=520 (ragged for the kernel,
    # padded to 544 by the wrapper)
    n, d = 8192, 256
    x = torch.randn(n, d, device=dev, generator=gen)
    q = torch.randn(520, d, device=dev, generator=gen)
    planted = [5, 32 * 9 + 2, 32 * 33, 32 * 71 + 8, 4096 + 32 * 3 + 1]
    for j, slot in enumerate(planted):
        x[slot] = q[0] * (1.0 + 0.01 * j)
    idx = _unit_index(x)
    qi, _ = quantize_queries_i8(q)
    for chunk in (2048, 4096):
        k2_pair(qi.contiguous(), idx.codes, chunk, f"small chunk={chunk} Q=520")
    _, ids = fs.fused_unit_i8_neg_topk(q[:3], idx.codes, idx.gscale,
                                       idx.bin_live, k=len(planted))
    check(set(ids[0].tolist()) == set(planted), "K2: planted rows lost")
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[4096:] = False
    live = fs.unit_i8_bin_live(valid, fs.chunk_for(n))
    negd, ids = fs.fused_unit_i8_neg_topk(x[5000:5001], idx.codes, idx.gscale,
                                          live, k=8)
    check(bool((ids < 4096).all()) and bool(torch.isfinite(negd).all()),
          "K2: a dead bin was returned")
    negd, _ = fs.fused_unit_i8_neg_topk(q[:2], idx.codes, idx.gscale,
                                        torch.zeros_like(live), k=3)
    check(bool(torch.isneginf(negd).all()), "K2: all-dead index scored")
    _, i_card = fs.fused_unit_i8_neg_topk(q, idx.codes, idx.gscale,
                                          idx.bin_live, k=1, final="exact")
    _, i_cpu = fs.fused_unit_i8_neg_topk(q.cpu(), idx.codes.cpu(),
                                         idx.gscale.cpu(), idx.bin_live.cpu(),
                                         k=1, final="exact")
    match = (i_card.cpu() == i_cpu).float().mean().item()
    check(match > 0.99, f"K2 Q=520 top-1 vs the plain version on the CPU: {match}")
    # the overflow edge: +-127 rows against a +-127 query at D=2048
    d = 2048
    signs = torch.where(torch.randn(4096, d, device=dev, generator=gen) >= 0,
                        127, -127).to(torch.int8)
    qs = signs[:40].clone()
    signs[128 + 1] = -qs[0]
    got, _ = k2_pair(qs, signs, 4096, "D=2048 +-127")
    check(got[0, 0].item() == (127 * 127 * 2048) << 5, "K2: overflow-edge key")
    log("[k2] small shapes: planted, dead bins, all-dead, Q=520 top-1, "
        "D=2048 overflow edge ok")
    tiling_edges(lambda q, codes, chunk, what: k2_pair(q, codes, chunk, what)[0],
                 gen, "K2", K2_EDGE_DIMS)
    log(f"[k2] int8 tiling edges: Q in {{1, 33, 520}} x chunk in {{2048, 4096}} "
        f"x D in {K2_EDGE_DIMS}, all-negative dots: keys bit-identical")

    # serving shape
    codes = torch.randint(-127, 128, (INDEX_N, DIM), device=dev,
                          dtype=torch.int8, generator=gen)
    record = None
    for nq in (8, QUERIES):
        qi = torch.randint(-127, 128, (nq, DIM), device=dev, dtype=torch.int8,
                           generator=gen)
        what = f"[k2] serving int8 Q={nq} N={INDEX_N}"
        out, err = k2_pair(qi, codes, 4096, what)
        plain_ms, ms, library_ms = timed(
            lambda: fs.binmax_scan_i8_ref(qi, codes, chunk=4096),
            lambda: fs.binmax_scan_i8(qi, codes, chunk=4096),
            int_mm_yardstick(qi, codes))
        bound_ms, bound_by = bound(qi, codes, out, ops_type="int8")
        rec = serving_record(what, err, ms, plain_ms, library_ms, bound_ms, bound_by)
        if nq == QUERIES:
            record = rec
        del out
    del codes
    torch.cuda.empty_cache()
    return record


# -- phase 3 -------------------------------------------------------------------

def _ground_truth(x_host, q_host, dev):
    """Exact cosine top-k on the card in f32 (TF32 off), row-blocked."""
    import torch

    qn = torch.nn.functional.normalize(torch.from_numpy(q_host).to(dev), dim=1)
    best_v, best_i = None, None
    block = 131072
    for lo in range(0, x_host.shape[0], block):
        xb = torch.from_numpy(x_host[lo:lo + block]).to(dev)
        s = qn @ torch.nn.functional.normalize(xb, dim=1).t()
        v, i = torch.topk(s, K, dim=1)
        i = i + lo
        if best_v is None:
            best_v, best_i = v, i
        else:
            v, sel = torch.topk(torch.cat([best_v, v], 1), K, dim=1)
            best_i = torch.gather(torch.cat([best_i, i], 1), 1, sel)
            best_v = v
    return best_i.cpu().numpy()


def _recall(ids_flat, counts, truth):
    from coltt_tpu_torch.ops.topk import compute_recall

    check(counts == [K] * len(counts), f"SearchBatch counts {set(counts)} != {K}")
    got = np.array([int(p) for p in ids_flat]).reshape(len(counts), K)
    return compute_recall(got, truth)


def make_data(device="cuda"):
    """Phase 3's and 4's rows and queries (numpy, from the seed) and the
    queries' exact f32 cosine top-k."""
    import torch

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    x = rng.standard_normal((N_ROWS, DIM), dtype=np.float32)
    queries = rng.standard_normal((QUERIES, DIM), dtype=np.float32)
    log(f"[data] {N_ROWS} x {DIM} f32 from seed {SEED}: "
        f"{time.perf_counter() - t0:.1f} s")
    return x, queries, _ground_truth(x, queries, torch.device(device))


def phase_server(tmp, data, device="cuda"):
    import grpc
    from coltt_tpu_torch.api.client import EdgeClient
    from coltt_tpu_torch.api.server import build_servicer, create_server
    from coltt_tpu_torch.index.filter import Filter, Op
    from coltt_tpu_torch.index.schema import CollectionSchema, FieldSchema, FieldType
    from coltt_tpu_torch.ops import fused_scan as fs
    from coltt_tpu_torch.ops.quant import Quantization
    from coltt_tpu_torch.utils.config import Config

    x, queries, truth = data
    cfg = Config()
    cfg.root_layer.bind_address = "127.0.0.1:0"
    cfg.root_layer.prof_address = "127.0.0.1:0"
    # a 20k-row f32 BulkIndex is 61 MB, above the 10 MB default
    cfg.root_layer.max_recv_msg_size = 256 << 20
    cfg.root_layer.max_send_msg_size = 256 << 20
    cfg.storage.data_dir = os.path.join(tmp, "data")
    cfg.storage.object_store_root = os.path.join(tmp, "objects")
    cfg.serving.device = device

    fs.reset_launch_counts()  # this path's counts
    server = create_server(build_servicer("edge", cfg), cfg)
    server.start()
    channel = grpc.insecure_channel(
        f"127.0.0.1:{server.bound_port}",
        options=[("grpc.max_send_message_length", 256 << 20),
                 ("grpc.max_receive_message_length", 256 << 20)])
    try:
        c = EdgeClient(channel)
        name = "flagship"
        c.create_collection(CollectionSchema(
            name=name, dim=DIM, quantization=Quantization.I8,
            fields=[FieldSchema("pk", FieldType.STRING, primary_key=True),
                    FieldSchema("tag", FieldType.STRING)]))
        t0 = time.perf_counter()
        for lo in range(0, N_ROWS, BULK_ROWS):
            hi = min(N_ROWS, lo + BULK_ROWS)
            c.bulk_index(name, [str(i) for i in range(lo, hi)], x[lo:hi],
                         [{"tag": f"t{i % TAGS}"} for i in range(lo, hi)])
        ingest_s = time.perf_counter() - t0
        check(c.get_collection(name).collection_size == N_ROWS, "size after ingest")
        log(f"[server] BulkIndex {N_ROWS} rows in {N_ROWS // BULK_ROWS} RPCs: "
            f"{ingest_s:.2f} s = {N_ROWS / ingest_s:.0f} rows/s (host staging; "
            f"rows are quantized on the card at the next search)")

        def search_batch(hr):
            return c.search_batch(name, queries, limit=K, high_resource=hr)

        t0 = time.perf_counter()
        before = fs.binmax_scan.launches
        counts, scores, ids_k1, _ = search_batch(True)
        first_s = time.perf_counter() - t0
        check(fs.binmax_scan.launches > before,
              "high_resource SearchBatch did not launch K1")
        check(all(np.isfinite(scores)), "non-finite scores")
        log(f"[server] first SearchBatch (incl. quantizing {N_ROWS} staged rows on "
            f"the card): {first_s:.2f} s")
        recall_k1 = _recall(ids_k1, counts, truth)
        before = fs.binmax_scan.launches
        counts, scores, ids_plain, _ = search_batch(False)
        scores_plain = np.asarray(scores, np.float32).reshape(len(counts), K)
        check(fs.binmax_scan.launches == before, "plain SearchBatch launched K1")
        check(all(np.isfinite(scores)), "non-finite scores")
        recall_plain = _recall(ids_plain, counts, truth)
        log(f"[server] recall@{K} vs f32 ground truth: high_resource (K1) "
            f"{recall_k1:.4f}, plain exact {recall_plain:.4f}")
        check(recall_k1 >= recall_plain - 0.01,
              f"K1 recall {recall_k1} more than 0.01 below plain {recall_plain}")
        check(recall_plain > 0.5, f"plain recall {recall_plain} implausibly low")

        p50 = {}
        for hr in (True, False):
            ts = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                search_batch(hr)
                ts.append((time.perf_counter() - t0) * 1e3)
            p50[hr] = statistics.median(ts)
        log(f"[server] SearchBatch Q={QUERIES} k={K} p50 over {REPS}: "
            f"high_resource (K1) {p50[True]:.1f} ms, plain exact "
            f"{p50[False]:.1f} ms")

        for r in range(3):
            for hr in (True, False):
                # one query alone: the same hits as its SearchBatch row, up
                # to a near-tie reordered by a reduction over another shape
                hits = [h["id"] for h in
                        c.search(name, queries[r], limit=K, high_resource=hr)]
                want = (ids_k1 if hr else ids_plain)[r * K:(r + 1) * K]
                check(hits[0] == want[0] and len(set(hits) & set(want)) >= K - 1,
                      f"Search {r} (high_resource={hr}) != its SearchBatch row")
        hits = c.search(name, queries[0], limit=K,
                        filter_expression=Filter("tag", Op.EQ, "t3"))
        check(len(hits) == K and all(h["metadata"]["tag"] == "t3" for h in hits),
              "filtered Search returned rows outside the tag")
        check(all(int(h["id"]) % TAGS == 3 for h in hits), "filtered pk/tag mismatch")
        log(f"[server] Search x6 and filtered Search on tag ok "
            f"(top score {hits[0]['score']:.3f})")

        t0 = time.perf_counter()
        c.flush(name)
        c.release_collection(name)
        check(not c.get_collection(name).load, "collection still loaded")
        c.load_collection(name)
        log(f"[server] Flush + Release + Load: {time.perf_counter() - t0:.1f} s")
        counts, _, ids_again, _ = search_batch(True)
        check(ids_again == ids_k1, "SearchBatch after reload returned other ids")
        launches = {"K1": fs.binmax_scan.launches, "K2": fs.binmax_scan_i8.launches}
        by_loop = dict(fs.binmax_scan.launches_by)
        log(f"[server] launches during the server run: {launches}, K1 by code "
            f"dtype and loop {by_loop}")
        check(launches["K2"] == 0, "the edge server launched K2")
        return {"launches": launches, "k1_by_loop": by_loop, "recall_k1": recall_k1,
                "recall_plain": recall_plain,
                "ids_plain": np.array([int(p) for p in ids_plain]).reshape(-1, K),
                "scores_plain": scores_plain}
    finally:
        channel.close()
        server.stop(None)


# -- phase 4 -------------------------------------------------------------------

def phase_flat_index(data, recall_server, device="cuda"):
    """The flat index at 1M x 768d: the I8 + bf16 index through K1's int8
    loop, the unit-i8 index through K2, the F8 + bf16 and BF16 indexes
    through K1's bf16 loop and the f32 index through its exact-f32 loop,
    then a short bench run on each index but the f32 one."""
    import torch
    from coltt_tpu_torch import bench
    from coltt_tpu_torch.ops import fused_scan as fs
    from coltt_tpu_torch.ops.quant import Quantization
    from coltt_tpu_torch.ops.topk import compute_recall
    from coltt_tpu_torch.parallel.dist_search import DistributedFlatIndex

    x, queries, truth = data
    dev = torch.device(device)
    t0 = time.perf_counter()
    xd = torch.from_numpy(x).to(dev)
    i8 = bench.build_index(xd, dev, unit_i8=False)
    unit = bench.build_index(xd, dev, unit_i8=True)
    f8 = DistributedFlatIndex(dev, xd, quantization=Quantization.F8,
                              rerank_dtype=torch.bfloat16)
    bf16 = DistributedFlatIndex(dev, xd, quantization=Quantization.BF16)
    gt = DistributedFlatIndex(dev, xd, quantization=Quantization.NONE)
    del xd
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"[index] upload + I8/bf16, unit-i8, F8/bf16, BF16 and f32 indexes: "
        f"{time.perf_counter() - t0:.2f} s")
    for idx in (i8, unit, f8, bf16, gt):
        check(idx.codes.shape[0] == -(-N_ROWS // 4096) * 4096,
              f"index rows {idx.codes.shape[0]}")

    fused = dict(fused=True, final="approx")
    # name, index, search kwargs, the (code dtype, loop) of K1 it runs
    # (None: K2)
    searches = (
        ("I8 K1 approx", i8, fused, ("int8", fs.LOOP_INT8)),
        ("I8 K1 slot2", i8, dict(fused=True, final="slot2"), ("int8", fs.LOOP_INT8)),
        ("unit-i8 K2 auto", unit, {}, None),
        ("F8 + bf16 rerank K1 approx", f8, fused, ("float8_e4m3fn", fs.LOOP_BF16)),
        ("BF16 K1 approx", bf16, fused, ("bfloat16", fs.LOOP_BF16)),
        ("f32 K1 approx", gt, fused, ("float32", fs.LOOP_F32)),
    )
    fs.reset_launch_counts()  # this path's counts
    # nothing on the queued path may wait for the device
    q_dev = torch.from_numpy(queries).to(dev)
    for idx in (i8, unit, f8, bf16, gt):
        idx.search_tensors(q_dev, K, oversample=OVERSAMPLE, **fused)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            idx.search_tensors(q_dev, K, oversample=OVERSAMPLE, **fused)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    log("[index] queued searches (K1's three loops and K2) never wait for the device")
    recalls = {}
    for name, idx, kw, k1_key in searches:
        before = (fs.binmax_scan.launches, fs.binmax_scan_i8.launches,
                  fs.binmax_scan.launches_by.get(k1_key, 0))
        t0 = time.perf_counter()
        scores, ids = idx.search(queries, K, oversample=OVERSAMPLE, **kw)
        dt = (time.perf_counter() - t0) * 1e3
        after = (fs.binmax_scan.launches, fs.binmax_scan_i8.launches,
                 fs.binmax_scan.launches_by.get(k1_key, 0))
        want = (True, False, True) if k1_key else (False, True, False)
        check(tuple(a > b for a, b in zip(after, before)) == want,
              f"{name}: launches K1 {before[0]}->{after[0]}, K2 {before[1]}->"
              f"{after[1]}, K1 {k1_key} {before[2]}->{after[2]}")
        check(scores.shape == (QUERIES, K) and np.isfinite(scores).all(),
              f"{name}: non-finite or misshapen scores")
        check(((ids >= 0) & (ids < N_ROWS)).all(), f"{name}: padding row returned")
        check((scores[:, :-1] >= scores[:, 1:] - 1e-4).all(),
              f"{name}: scores not descending")
        recalls[name] = compute_recall(ids, truth)
        log(f"[index] {name}: recall@{K} {recalls[name]:.4f} ({QUERIES} "
            f"queries, first search {dt:.1f} ms)")
        check(recalls[name] >= 0.95 and recalls[name] >= recall_server - 0.01,
              f"{name}: recall {recalls[name]} below 0.95 or phase 3's "
              f"{recall_server} - 0.01")

    for idx in (i8, unit, f8, bf16):
        record = bench.run(idx, gt, np.random.default_rng(SEED + 1),
                           warm=1, rounds=2)
        record["device"] = bench.card()
        log(json.dumps(record))
    if dev.type == "cuda":
        prof = bench.device_profile(f8, np.random.default_rng(SEED + 2))
        log(f"[index] F8 + bf16 rerank, one queued round of {bench.DEPTH} x "
            f"{bench.BATCH} queries under torch.profiler: {json.dumps(prof)}")
    launches = {"K1": fs.binmax_scan.launches, "K2": fs.binmax_scan_i8.launches}
    by_loop = dict(fs.binmax_scan.launches_by)
    log(f"[index] launches during the flat-index run: {launches}, K1 by code "
        f"dtype and loop {by_loop}")
    # the I8 + bf16 index stays for the frontier (phase 4b)
    return {"launches": launches, "k1_by_loop": by_loop, "recalls": recalls,
            "i8": i8}


# -- phase 4b ------------------------------------------------------------------

def phase_frontier(data, i8=None, device="cuda"):
    """The selection frontier (``python -m coltt_tpu_torch.bench_frontier``)
    on phase 4's rows, queries and ground truth, through phase 4's I8 +
    bf16 index (built again only when it is not passed)."""
    import torch
    from coltt_tpu_torch import bench
    from coltt_tpu_torch import bench_frontier as bf
    from coltt_tpu_torch.ops import fused_scan as fs

    x, queries, truth = data
    dev = torch.device(device)
    t0 = time.perf_counter()
    if i8 is None:
        i8 = bench.build_index(torch.from_numpy(x).to(dev), dev, unit_i8=False)
    rng = np.random.default_rng(SEED + 3)
    q_batches = [torch.from_numpy(rng.standard_normal((QUERIES, DIM), dtype=np.float32))
                 .to(dev) for _ in range(bf.DEPTH)]
    card = bench.smi_line() if dev.type == "cuda" else dev.type
    fs.reset_launch_counts()  # this path's counts
    records, detail = bf.frontier(i8, q_batches, queries, truth, warm=1, rounds=3)
    launches = {"K1": fs.binmax_scan.launches, "K2": fs.binmax_scan_i8.launches}
    by_loop = dict(fs.binmax_scan.launches_by)
    for final, rec in records.items():
        log(f"[frontier] {final}: QPS {rec['qps']:.0f} (depth {bf.DEPTH} x "
            f"{QUERIES}, rounds {[round(r) for r in rec['qps_rounds']]}), p50 "
            f"{rec['p50_batch_latency_ms']:.3f} ms, recall@{K} "
            f"{rec['recall_at_10']:.4f}, ids equal to exact's "
            f"{rec['ids_equal_to_exact']:.4f}, selection (CUDA-event wall) "
            f"{rec['selection_ms']:.3f} ms, K1 a search "
            f"{rec['k1_launches_per_search']} ({card})")
        check(rec["recall_at_10"] >= 0.95,
              f"frontier {final}: recall {rec['recall_at_10']} below 0.95")
    exact = detail["exact"]
    for final in ("slot2t", "slot2c", "slot2a"):
        check(np.array_equal(detail[final]["ids"], detail["slot2"]["ids"]),
              f"frontier: {final}'s ids differ from slot2's")
    tied = {}
    for final in ("approx", "approx2"):
        got = detail[final]
        # the same key values at every rank; where the selected bins differ,
        # the keys tied (torch.topk's order among equal keys is not fixed)
        check(np.array_equal(got["sel"], exact["sel"]),
              f"frontier: {final} selects other keys than exact")
        same_bins = np.array([set(a) == set(b)
                              for a, b in zip(got["pos"], exact["pos"])])
        tied[final] = int((~same_bins).sum())
        check(np.array_equal(got["ids"][same_bins], exact["ids"][same_bins]),
              f"frontier: {final}'s ids differ from exact's on the same bins")
    check(launches["K1"] > 0 and launches["K2"] == 0,
          f"frontier launches {launches}")
    seconds = time.perf_counter() - t0
    log(f"[frontier] slot2t / slot2c / slot2a return slot2's ids; approx and "
        f"approx2 select exact's keys (queries whose bins differ by a tie: "
        f"{tied}); launches {launches}, K1 by code dtype and loop {by_loop}; "
        f"phase {seconds:.1f} s")
    return {"launches": launches, "k1_by_loop": by_loop, "finals": records,
            "tied_queries": tied, "seconds": seconds}


# -- phase 10 ------------------------------------------------------------------

def phase_quickstart(tmp, device="cuda"):
    """The port's quickstart (``python -m coltt_tpu_torch.quickstart``):
    the three engines end to end on ``device``."""
    from coltt_tpu_torch import quickstart
    from coltt_tpu_torch.ops import fused_scan as fs

    fs.reset_launch_counts()
    t0 = time.perf_counter()
    check(quickstart.main([tmp, "--device", device]) == 0, "quickstart failed")
    seconds = time.perf_counter() - t0
    launches = {"K1": fs.binmax_scan.launches, "K2": fs.binmax_scan_i8.launches}
    log(f"[quickstart] three engines on {device}: {seconds:.2f} s, launches "
        f"{launches}")
    return {"seconds": seconds, "launches": launches}


# -- phase 9 -------------------------------------------------------------------

def _same_ranks(got, want, tol, what):
    """``(scores, ids)`` pairs: scores within ``tol`` at every rank, and
    the same ids at every rank up to ties: within each run of ranks whose
    wanted scores lie within ``tol`` the ids compare as sets, except the
    last run, which k may cut. Returns the share of ranks with equal ids."""
    (gs, gi), (ws, wi) = got, want
    check(gs.shape == ws.shape and np.allclose(gs, ws, rtol=0, atol=tol),
          f"{what}: scores differ (max {np.abs(gs - ws).max()})")
    for r in range(ws.shape[0]):
        start = 0
        for p in range(1, ws.shape[1]):
            if ws[r, p] < ws[r, p - 1] - tol:
                check(set(gi[r, start:p]) == set(wi[r, start:p]),
                      f"{what}: query {r} ranks {start}-{p - 1}: {gi[r, start:p]} "
                      f"!= {wi[r, start:p]}")
                start = p
    return float((gi == wi).mean())


def _fake_s3():
    """``tests/fake_s3.py`` of this checkout, loaded by its path (a package
    named ``tests`` elsewhere on the path would shadow the directory)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fake_s3.py")
    spec = importlib.util.spec_from_file_location("coltt_fake_s3", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _counting_s3(endpoint):
    """An ``S3ObjectStore`` on ``endpoint`` that counts the bytes its
    streamed PUTs send and its streamed reads return (the checkpoint's
    size)."""
    from coltt_tpu_torch.storage.s3 import S3ObjectStore

    class Counting(S3ObjectStore):
        sent = 0
        read_back = 0

        def put_object_stream(self, bucket, name, writer):
            store = self

            class Tap:
                def __init__(self, f):
                    self.f = f

                def write(self, b):
                    store.sent += len(b)
                    return self.f.write(b)

            super().put_object_stream(bucket, name, lambda f: writer(Tap(f)))

        def open_object(self, bucket, name):
            body = super().open_object(bucket, name)
            if body is None:
                return None
            store, read = self, body.read

            def counted(n=-1):
                b = read(n)
                store.read_back += len(b)
                return b

            body.read = counted
            return body

    return Counting(endpoint)


def _shard_worker_run(work, backend, nproc, device):
    """Run ``nproc`` shard workers (``chip_smoke.py --shard-worker``) of
    ``backend`` on this card under timeouts; returns each one's
    ``(scores, ids)``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.dirname(os.path.abspath(__file__)),
                      os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-worker",
         f"127.0.0.1:{port}", str(nproc), str(rank), backend, work, device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SHARD_WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{backend} worker {rank} failed:\n{out[-4000:]}")
        log(out.strip().splitlines()[-1])
    return [(np.load(os.path.join(work, f"{backend}-{rank}-scores.npy")),
             np.load(os.path.join(work, f"{backend}-{rank}-ids.npy")))
            for rank in range(nproc)]


def shard_worker(argv) -> int:
    """One process of phase 9c: joins the process group (checking that
    the backend rule chose ``backend``), places this process's share of
    the 4 shards (all on this card) from the rows the parent wrote, runs
    the raw K1 search of 9a and saves the merged result. ``argv``:
    coordinator, process count, rank, expected backend, dir, device."""
    import torch
    from coltt_tpu_torch.ops import fused_scan as fs
    from coltt_tpu_torch.ops.distance import Metric
    from coltt_tpu_torch.ops.quant import Quantization, dequantize, quantize
    from coltt_tpu_torch.parallel import dist_search as tds
    from coltt_tpu_torch.parallel.multihost import (
        assemble_global_rows, host_row_range, init_distributed, make_multihost_mesh,
    )

    coord, nproc, rank, backend, work = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    dev = torch.device(argv[5])
    t0 = time.perf_counter()
    devices = [dev] * (SHARDS // nproc)
    # the rule of parallel/multihost.py must pick the expected backend
    # from the processes' devices
    check(init_distributed(coord, num_processes=nproc, process_id=rank, devices=devices,
                           timeout_s=60) == nproc, "process group")
    check(torch.distributed.get_backend() == backend,
          f"backend rule chose {torch.distributed.get_backend()}, expected {backend}")
    if dev.type == "cuda":
        fs.load_kernels()
    mesh = make_multihost_mesh(devices=devices)
    total = np.load(os.path.join(work, "meta.npy"))[0]
    start, end = host_row_range(int(total), mesh)
    rows = torch.from_numpy(np.concatenate([
        np.load(os.path.join(work, f"rows-{h}.npy"), mmap_mode="r")
        for h in range(2)])[start:end] if nproc == 1 else
        np.load(os.path.join(work, f"rows-{rank}.npy"))).to(dev)
    codes, scale = quantize(rows, Quantization.I8)
    deq = dequantize(codes, scale)
    valid = torch.arange(start, end, device=dev) < N_ROWS
    arrays = [assemble_global_rows(mesh, a, int(total))
              for a in (codes, scale, (deq * deq).sum(dim=1), valid)]
    q = torch.from_numpy(np.load(os.path.join(work, "queries.npy"))).to(dev)
    scores, ids = tds.sharded_scan_topk(mesh, *arrays, q, k=K, metric=Metric.COSINE,
                                        compute_dtype=torch.bfloat16, fused=True,
                                        final="approx")
    np.save(os.path.join(work, f"{backend}-{rank}-scores.npy"), scores.cpu().numpy())
    np.save(os.path.join(work, f"{backend}-{rank}-ids.npy"), ids.cpu().numpy())
    torch.distributed.destroy_process_group()
    print(f"[sharded] {backend} worker {rank}/{nproc}: rows [{start}, {end}) on "
          f"{mesh.local_shards} shards, {fs.binmax_scan.launches} K1 launches, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def phase_sharded(tmp, data, server_run, index_run, device="cuda"):
    """Phase 9: the sharded paths on one card, on phase 3's rows."""
    import torch
    from coltt_tpu_torch import bench
    from coltt_tpu_torch.engine.edge import EdgeEngine
    from coltt_tpu_torch.index.schema import CollectionSchema, FieldSchema, FieldType
    from coltt_tpu_torch.ops import fused_scan as fs
    from coltt_tpu_torch.ops.distance import Metric
    from coltt_tpu_torch.ops.pq import train_pq
    from coltt_tpu_torch.ops.quant import Quantization
    from coltt_tpu_torch.ops.topk import compute_recall, fetch_scores_ids
    from coltt_tpu_torch.parallel import dist_search as tds
    from coltt_tpu_torch.parallel.mesh import make_mesh
    from coltt_tpu_torch.store.flat import FlatStore

    t_phase = time.perf_counter()
    x, queries, truth = data
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh4 = make_mesh(SHARDS, devices=[dev] * SHARDS)
    mesh1 = make_mesh(1, devices=[dev])
    t0 = time.perf_counter()
    xd = torch.from_numpy(x).to(dev)
    i8_4 = bench.build_index(xd, mesh4, unit_i8=False)
    i8_1 = bench.build_index(xd, mesh1, unit_i8=False)
    unit4 = bench.build_index(xd, mesh4, unit_i8=True)
    q_dev = torch.from_numpy(queries).to(dev)
    log(f"[sharded] 9a: I8 + bf16 and unit-i8 indexes over {SHARDS} shards of {dev} "
        f"({i8_4.codes.local_n} rows each) and I8 over a 1-shard mesh: "
        f"{time.perf_counter() - t0:.2f} s")
    raw = dict(k=K, metric=Metric.COSINE, compute_dtype=torch.bfloat16, fused=True,
               final="approx")
    arrays4 = (i8_4.codes, i8_4.scale, i8_4.sqnorm, i8_4.valid)
    srk = dict(oversample=OVERSAMPLE, fused=True, final="approx")

    # one-device references first, so the sharded path's counts are its own:
    # K1 over the 4-shard layout's rows on one device (the same bins)
    flat = [torch.cat(a.host_blocks()) for a in arrays4]
    one_raw = fetch_scores_ids(*tds.sharded_scan_topk(dev, *flat, q_dev, **raw))
    del flat
    one_bypass = i8_1.search(queries, K, **srk)
    sub = x[:SHARD_N]
    sub_q = queries[:512]
    bq1 = tds.DistributedFlatIndex(dev, sub, quantization=Quantization.BQ)
    bq4 = tds.DistributedFlatIndex(mesh4, sub, quantization=Quantization.BQ)
    one_bq = bq1.search(sub_q, K)
    cb = train_pq(torch.from_numpy(sub).to(dev), m=DIM // 8, iters=4)
    pq = {}
    for name, where, host in (("one", dev, False), ("mesh", mesh4, False),
                              ("mesh-host", mesh4, True)):
        st = FlatStore(DIM, quantization=Quantization.PQ, pq_subspaces=DIM // 8,
                       device=where, pq_host_codes=host)
        st.codebook = cb
        st.upsert_many([str(i) for i in range(SHARD_N)], sub)
        st.sync()
        pq[name] = st
    one_pq = pq["one"].search(sub_q, K, fused=True)
    one_pq4 = pq["one"].search(sub_q, K, fused=True, oversample=4)
    xb = x[SHARD_N:2 * SHARD_N, :256]
    fields = []
    for part in (sub, xb):
        t = torch.from_numpy(np.ascontiguousarray(part)).to(dev)
        fields.append((t, None, (t * t).sum(dim=1)))
    cvalid = torch.ones(SHARD_N, dtype=torch.bool, device=dev)
    cq = (torch.from_numpy(sub_q).to(dev),
          torch.from_numpy(np.ascontiguousarray(x[-len(sub_q):, :256])).to(dev))
    ckw = dict(k=K, metric=Metric.COSINE, compute_dtype=torch.bfloat16)
    one_cflat = fetch_scores_ids(*tds.sharded_cflat_topk(dev, fields, cvalid, cq,
                                                          (0.7, 0.3), **ckw))

    fs.reset_launch_counts()  # the sharded path's counts, 9a and 9b
    before = (fs.binmax_scan.launches, fs.binmax_scan_i8.launches)
    got_raw = fetch_scores_ids(*tds.sharded_scan_topk(mesh4, *arrays4, q_dev, **raw))
    k1_per_search = fs.binmax_scan.launches - before[0]
    check(k1_per_search > 0 and k1_per_search % SHARDS == 0,
          f"4-shard K1 search launched K1 {k1_per_search} times")
    eq = _same_ranks(got_raw, one_raw, 0.0, "4-shard K1 (no rerank)")
    log(f"[sharded] K1 per shard, no rerank: ids equal to the one-device K1 scan of "
        f"the same rows at {eq:.6f} of the ranks (ties aside: all), "
        f"{k1_per_search} K1 launches a search")
    scores, ids = i8_4.search(queries, K, **srk)
    recall4 = compute_recall(ids, truth)
    want = index_run["recalls"]["I8 K1 approx"]
    check(((ids >= 0) & (ids < N_ROWS)).all(), "4-shard rerank returned padding")
    check(recall4 >= want, f"4-shard K1 + rerank recall {recall4} < one-device {want}")
    nb = i8_1.search(queries, K, bypass_single=False, **srk)
    check((nb[1] == one_bypass[1]).all() and np.array_equal(nb[0], one_bypass[0]),
          "bypass_single=False on 1 shard differs from the bypass")
    before = fs.binmax_scan_i8.launches
    scores, ids = unit4.search(queries, K, oversample=OVERSAMPLE)
    k2_per_search = fs.binmax_scan_i8.launches - before
    check(k2_per_search > 0 and k2_per_search % SHARDS == 0,
          f"4-shard unit-i8 search launched K2 {k2_per_search} times")
    recall_unit = compute_recall(ids, truth)
    want_unit = index_run["recalls"]["unit-i8 K2 auto"]
    check(recall_unit >= want_unit,
          f"4-shard unit-i8 recall {recall_unit} < one-device {want_unit}")
    log(f"[sharded] recall@{K}: 4-shard K1 + bf16 rerank {recall4:.4f} (one device "
        f"{want:.4f}), 4-shard unit-i8 K2 {recall_unit:.4f} (one device "
        f"{want_unit:.4f}), {k2_per_search} K2 launches a search; 1 shard without "
        f"the bypass equals the bypass")
    eq_bq = _same_ranks(bq4.search(sub_q, K), one_bq, 0.0, "4-shard BQ")
    eq_pq = _same_ranks(pq["mesh"].search(sub_q, K, fused=True), one_pq, 0.0,
                        "4-shard PQ cache (K1)")
    pq4 = pq["mesh"].search(sub_q, K, fused=True, oversample=4)
    pqh = pq["mesh-host"].search(sub_q, K, fused=True, oversample=4)
    check(np.array_equal(pq4[1], pqh[1]) and np.array_equal(pq4[0], pqh[0]),
          "4-shard PQ rerank: host codes differ from device codes")
    pq_overlap = compute_recall(pq4[1], one_pq4[1])
    check(pq_overlap >= 0.95, f"4-shard PQ rerank overlap {pq_overlap} with one device")
    eq_cf = _same_ranks(fetch_scores_ids(*tds.sharded_cflat_topk(
        mesh4, fields, cvalid, cq, (0.7, 0.3), **ckw)), one_cflat, 1e-4, "4-shard CFLAT")
    log(f"[sharded] at {SHARD_N} rows, 4 shards against one device: BQ ids "
        f"{eq_bq:.4f} equal (ties aside all), PQ cache through K1 {eq_pq:.4f}, "
        f"PQ exact rerank host codes == device codes, {pq_overlap:.4f} of the "
        f"one-device rerank's ids, CFLAT {eq_cf:.4f}")
    del pq, bq1, bq4, fields, cq

    # 9b: an edge engine over the 4-shard mesh, checkpointed through S3
    srv, addr = _fake_s3().start_fake_s3()
    try:
        s3 = _counting_s3(addr)
        eng = EdgeEngine(s3, mesh=mesh4, batch_max=0, warmup_batches=())
        name = "sharded"
        eng.create_collection(CollectionSchema(
            name=name, dim=DIM, quantization=Quantization.I8,
            fields=[FieldSchema("pk", FieldType.STRING, primary_key=True),
                    FieldSchema("tag", FieldType.STRING)]))
        t0 = time.perf_counter()
        for lo in range(0, N_ROWS, BULK_ROWS):
            hi = min(N_ROWS, lo + BULK_ROWS)
            eng.index_many(name, [{"pk": str(i), "tag": f"t{i % TAGS}"}
                                  for i in range(lo, hi)], x[lo:hi])
        ingest_s = time.perf_counter() - t0

        def batch(hr):
            counts, scores, pks, _ = eng.search_batch(name, queries, limit=K,
                                                      high_resource=hr)
            check(counts == [K] * len(counts), f"9b counts {set(counts)}")
            return (np.asarray(scores, np.float32).reshape(-1, K),
                    np.array([int(p) for p in pks]).reshape(-1, K))

        plain = batch(False)
        store = eng._collections[name].store
        check(store.mesh is mesh4 and store.capacity == SERVING_N,
              f"9b store layout {store.mesh} {store.capacity}")
        eq_plain = _same_ranks(plain, (server_run["scores_plain"], server_run["ids_plain"]),
                               1e-4, "9b plain SearchBatch vs phase 3")
        hr = batch(True)
        recall_hr = compute_recall(hr[1], truth)
        check(recall_hr >= server_run["recall_k1"] - 0.001,
              f"9b high_resource recall {recall_hr} < phase 3's "
              f"{server_run['recall_k1']} - 0.001")
        from coltt_tpu_torch.index.filter import Filter, Op

        hits = eng.search(name, queries[0], limit=K,
                          filter_expression=Filter("tag", Op.EQ, "t3"))
        check(len(hits) == K and all(h.metadata["tag"] == "t3" and int(h.id) % TAGS == 3
                                     for h in hits), "9b filtered search left its rows")
        sent, t0 = s3.sent, time.perf_counter()
        eng.flush(name)
        flush_s = time.perf_counter() - t0
        flushed = s3.sent - sent
        eng.release_collection(name)
        t0 = time.perf_counter()
        eng.load_collection(name)
        load_s = time.perf_counter() - t0
        check(eng._collections[name].store.mesh is mesh4, "9b reload lost the mesh")
        again_plain, again_hr = batch(False), batch(True)
        check(np.array_equal(again_plain[1], plain[1]) and np.array_equal(again_hr[1], hr[1]),
              "9b SearchBatch after the S3 reload returned other ids")
        vertex = s3.read_back
        log(f"[sharded] 9b: edge engine over {SHARDS} shards, S3 object store: "
            f"{N_ROWS} rows indexed in {ingest_s:.2f} s; plain SearchBatch ids equal "
            f"phase 3's at {eq_plain:.6f} of the ranks (ties aside all); high_resource "
            f"recall@{K} {recall_hr:.4f} (phase 3 {server_run['recall_k1']:.4f}); "
            f"filtered Search ok; Flush {flushed} bytes in {flush_s:.2f} s = "
            f"{flushed / flush_s / 1e6:.1f} MB/s, Load {vertex} bytes of the vertex in "
            f"{load_s:.2f} s = {vertex / load_s / 1e6:.1f} MB/s; same ids after")
        del eng, store
    finally:
        srv.shutdown()
    launches = {"K1": fs.binmax_scan.launches, "K2": fs.binmax_scan_i8.launches}
    by_loop = dict(fs.binmax_scan.launches_by)
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"the sharded path launched K1 {launches['K1']}, K2 {launches['K2']} times")
    log(f"[sharded] launches during the sharded run (9a, 9b): {launches}, K1 by code "
        f"dtype and loop {by_loop}")

    # QPS and p50 of the flagship search on 1 shard, 1 without the bypass, 4
    rng = np.random.default_rng(SEED + 9)
    q_batches = [torch.from_numpy(rng.standard_normal((QUERIES, DIM), dtype=np.float32))
                 .to(dev) for _ in range(8)]
    timing = {}
    for label, idx, bypass in (("1", i8_1, True), ("1-no-bypass", i8_1, False),
                               ("4", i8_4, True)):
        def dispatch(q, idx=idx, bypass=bypass):
            return idx.search_tensors(q, K, bypass_single=bypass, **srk)

        _, p50, qps, _ = bench.time_dispatch(dispatch, q_batches, warm=1, rounds=2)
        timing[label] = {"qps": qps, "p50_ms": p50}
    log(f"[sharded] flagship search, Q={QUERIES}, 8 queued, median of 2: "
        + ", ".join(f"{k} shard(s) {v['qps']:.1f} QPS p50 {v['p50_ms']:.2f} ms"
                    for k, v in timing.items())
        + f"; 4 shards at {timing['4']['qps'] / timing['1']['qps']:.3f} of one")
    if dev.type == "cuda":
        prof = {n: bench.device_profile(idx, np.random.default_rng(SEED + 2))
                for n, idx in (("1", i8_1), ("4", i8_4))}
        log(f"[sharded] one queued round of {bench.DEPTH} x {bench.BATCH} queries "
            f"under torch.profiler, 1 shard and 4 shards: {json.dumps(prof)}")
    del i8_1, i8_4, unit4, xd

    # 9c: two processes on this card over gloo, then one process over NCCL
    work = os.path.join(tmp, "shard-workers")
    os.makedirs(work, exist_ok=True)
    total = arrays4[0].shape[0]
    half = total // 2
    np.save(os.path.join(work, "rows-0.npy"), x[:half])
    np.save(os.path.join(work, "rows-1.npy"), np.concatenate(
        [x[half:], np.zeros((total - N_ROWS, DIM), np.float32)]))
    np.save(os.path.join(work, "queries.npy"), queries)
    np.save(os.path.join(work, "meta.npy"), np.array([total]))
    del arrays4
    for backend, nproc in (("gloo", 2), ("nccl", 1))[:2 if dev.type == "cuda" else 1]:
        t0 = time.perf_counter()
        outs = _shard_worker_run(work, backend, nproc, str(dev))
        for rank, out in enumerate(outs):
            check(np.array_equal(out[1], got_raw[1]) and np.allclose(
                out[0], got_raw[0], rtol=0, atol=1e-5),
                f"9c {backend} rank {rank}: the merged result differs from 9a's")
        log(f"[sharded] 9c: {nproc} process(es) over {backend} on {dev}, each placing "
            f"its own rows: the 4-shard K1 result of 9a, {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"[sharded] phase 9 in {phase_s:.1f} s")
    return {"launches": launches, "k1_by_loop": by_loop, "k1_per_search": k1_per_search,
            "k2_per_search": k2_per_search, "recall_rerank": recall4,
            "recall_unit_i8": recall_unit, "recall_edge_hr": recall_hr,
            "timing": timing, "checkpoint_bytes": flushed, "flush_s": flush_s,
            "load_s": load_s, "seconds": phase_s}


# -- phases 5 and 6 ------------------------------------------------------------

def _grpc_server(tmp, device, mode="edge"):
    """A started server of ``mode`` (edge, experimental or root), its
    servicer's engine and a client on it. Messages up to 512 MB: a
    65,536-row BulkIndex of two 768d fields is 403 MB."""
    import grpc
    from coltt_tpu_torch.api.client import CoreClient, EdgeClient, ExperimentalClient
    from coltt_tpu_torch.api.server import build_servicer, create_server
    from coltt_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.root_layer.bind_address = "127.0.0.1:0"
    cfg.root_layer.prof_address = "127.0.0.1:0"
    cfg.root_layer.max_recv_msg_size = 512 << 20
    cfg.root_layer.max_send_msg_size = 512 << 20
    cfg.storage.data_dir = os.path.join(tmp, "data")
    cfg.storage.object_store_root = os.path.join(tmp, "objects")
    cfg.serving.device = device
    servicer = build_servicer(mode, cfg)
    server = create_server(servicer, cfg)
    server.start()
    channel = grpc.insecure_channel(
        f"127.0.0.1:{server.bound_port}",
        options=[("grpc.max_send_message_length", 512 << 20),
                 ("grpc.max_receive_message_length", 512 << 20)])
    client = {"experimental": ExperimentalClient, "root": CoreClient}.get(mode, EdgeClient)
    return server, channel, servicer.engine, client(channel)


def _ingest(c, name, x_host, what):
    from coltt_tpu_torch.index.schema import CollectionSchema, FieldSchema, FieldType

    n = x_host.shape[0]
    c.create_collection(CollectionSchema(
        name=name, dim=DIM, quantization=what,
        fields=[FieldSchema("pk", FieldType.STRING, primary_key=True),
                FieldSchema("tag", FieldType.STRING)]))
    t0 = time.perf_counter()
    for lo in range(0, n, BULK_ROWS):
        hi = min(n, lo + BULK_ROWS)
        c.bulk_index(name, [str(i) for i in range(lo, hi)], x_host[lo:hi],
                     [{"tag": f"t{i % TAGS}"} for i in range(lo, hi)])
    check(c.get_collection(name).collection_size == n, f"{name}: size after ingest")
    log(f"[{name}] BulkIndex {n} rows: {time.perf_counter() - t0:.2f} s")


def _batch_ids(c, name, queries, hr):
    counts, scores, ids, _ = c.search_batch(name, queries, limit=K, high_resource=hr)
    check(counts == [K] * len(counts), f"{name}: SearchBatch counts {set(counts)}")
    check(all(np.isfinite(scores)), f"{name}: non-finite scores")
    s = np.asarray(scores).reshape(len(counts), K)
    check((s[:, :-1] >= s[:, 1:] - 1e-4).all(), f"{name}: scores not descending")
    return np.array([int(p) for p in ids]).reshape(len(counts), K)


def _sync_p50(fn, reps=REPS):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _filtered_and_reload(c, name, queries, ids_hr):
    """A tag-filtered Search, then Flush / Release / Load: the same ids."""
    from coltt_tpu_torch.index.filter import Filter, Op

    hits = c.search(name, queries[0], limit=K, filter_expression=Filter("tag", Op.EQ, "t3"))
    check(len(hits) == K and all(h["metadata"]["tag"] == "t3" for h in hits)
          and all(int(h["id"]) % TAGS == 3 for h in hits),
          f"{name}: filtered Search returned rows outside the tag")
    t0 = time.perf_counter()
    c.flush(name)
    c.release_collection(name)
    check(not c.get_collection(name).load, f"{name}: still loaded")
    c.load_collection(name)
    reload_s = time.perf_counter() - t0
    again = _batch_ids(c, name, queries, True)
    check((again == ids_hr).all(), f"{name}: SearchBatch after reload returned other ids")
    log(f"[{name}] filtered Search ok; Flush + Release + Load {reload_s:.2f} s, "
        f"same ids after reload")
    return reload_s


def phase_bq(tmp, device="cuda"):
    """Phase 5: the BQ index and an edge BQ collection at 1M x 768."""
    import torch
    from coltt_tpu_torch import bench, bench_bq
    from coltt_tpu_torch.ops import bq
    from coltt_tpu_torch.ops.quant import Quantization
    from coltt_tpu_torch.ops.topk import compute_recall
    from coltt_tpu_torch.parallel.dist_search import DistributedFlatIndex

    dev = torch.device(device)
    t0 = time.perf_counter()
    g, centers = bench_bq.make_centers(SEED, dev)
    gq = torch.Generator(device=dev).manual_seed(SEED + 1)
    queries = bench.mixture_rows(gq, centers, QUERIES, bench_bq.SIGMA)
    q_batches = [bench.mixture_rows(gq, centers, QUERIES, bench_bq.SIGMA)
                 for _ in range(bench_bq.DEPTH)]
    packed, rr, truth = bench_bq.make_corpus(SERVING_N, g, centers, queries)
    log(f"[bq] {SERVING_N} x {DIM} mixture rows made, packed ({packed.numel() * 4} "
        f"bytes) and ground-truthed: {time.perf_counter() - t0:.2f} s")

    # the +-1 form against the plain popcount over the same words: the
    # exact keep rank for rank, ids included; the capped keep (what a
    # rerank follows) the same distances, each id a distinct row at its
    # stated distance (the tie group at a block's cut is not settled)
    qp = bq.bq_encode(queries)
    kk = K * BQ_OVERSAMPLE
    ref_h, ref_i = bq.bq_scan_neg_topk_ref(qp, packed, None, k=kk)
    ex_h, ex_i = bq.bq_scan_neg_topk(qp, packed, None, k=kk, exact=True)
    check(torch.equal(ex_h, ref_h) and torch.equal(ex_i, ref_i),
          "bq: the exact Hamming shortlist differs from the plain popcount")
    negh, ids = bq.bq_scan_neg_topk(qp, packed, None, k=kk)
    check(torch.equal(negh, ref_h), "bq: Hamming shortlist differs from the plain "
          f"popcount (max {float((negh - ref_h).abs().max())})")
    x = torch.bitwise_xor(qp[:, None, :], packed[ids.long()]).view(torch.uint8)
    ham = sum(((x >> b) & 1).sum(dim=-1, dtype=torch.int32) for b in range(8))
    check(torch.equal(-ham.to(torch.float32), negh), "bq: a shortlist id is not "
          "at its stated distance")
    check(bool((ids.sort(dim=1).values.diff(dim=1) > 0).all()),
          "bq: a shortlist repeats a row")
    same_ids = float((ids == ref_i).float().mean())
    mm_ms, ex_ms, pop_ms = timed(
        lambda: bq.bq_scan_neg_topk(qp, packed, None, k=kk),
        lambda: bq.bq_scan_neg_topk(qp, packed, None, k=kk, exact=True),
        lambda: bq.bq_scan_neg_topk_ref(qp, packed, None, k=kk), reps=3)
    log(f"[bq] Hamming top-{kk}, Q={QUERIES}: +-1 form (torch._int_mm), capped keep "
        f"{mm_ms:.3f} ms, exact keep {ex_ms:.3f} ms, plain popcount {pop_ms:.3f} ms; "
        f"distances identical at every rank, ids identical (exact) and at rank "
        f"{same_ids:.4f} (capped)")

    records = {}
    for name, copy in (("bf16-rerank", rr), ("no-rerank", None)):
        idx = DistributedFlatIndex.from_bq_codes(dev, packed, dim=DIM, rr_codes=copy)
        scores, got = idx.search(queries.cpu().numpy(), K, oversample=BQ_OVERSAMPLE)
        check(np.isfinite(scores).all() and ((got >= 0) & (got < SERVING_N)).all(),
              f"bq {name}: non-finite score or padding row")
        check((scores[:, :-1] >= scores[:, 1:] - 1e-4).all(),
              f"bq {name}: scores not descending")
        rec = bench_bq.measure(idx, queries, truth, q_batches, BQ_OVERSAMPLE)
        records[name] = rec
        log(f"[bq] index {name} os{BQ_OVERSAMPLE}: {json.dumps(rec)}")
        if dev.type == "cuda" and copy is not None:
            prof = bench.profile_round(lambda: [
                bench.fetch_scores_ids(*idx.search_tensors(q, K, oversample=BQ_OVERSAMPLE))
                for q in q_batches])
            log(f"[bq] index {name}, one round of {len(q_batches)} x {QUERIES} "
                f"queries under torch.profiler: {json.dumps(prof)}")
            records["profile"] = prof
        del idx
    check(records["bf16-rerank"]["recall_at_10"] >= 0.95,
          f"bq: rerank recall {records['bf16-rerank']['recall_at_10']} < 0.95")

    # the edge BQ collection over gRPC, on the same rows (bf16-rounded:
    # the signs and the bf16 copy are those above)
    x_host = rr.to(torch.float32).cpu().numpy()
    q_host = queries.cpu().numpy()
    del packed, rr
    server, channel, _, c = _grpc_server(tmp, device)
    try:
        name = "bq"
        _ingest(c, name, x_host, Quantization.BQ)
        t0 = time.perf_counter()
        ids_hr = _batch_ids(c, name, q_host, True)
        first_s = time.perf_counter() - t0
        ids_plain = _batch_ids(c, name, q_host, False)
        check((ids_hr == ids_plain).all(), "bq: high_resource changed a BQ search")
        recall = compute_recall(ids_hr, truth)
        p50 = _sync_p50(lambda: c.search_batch(name, q_host, limit=K))
        log(f"[bq] edge SearchBatch Q={QUERIES} (os 64, bf16 rerank): recall@{K} "
            f"{recall:.4f}, first {first_s:.2f} s (incl. encoding), p50 {p50:.1f} ms")
        check(recall >= 0.95, f"bq: edge recall {recall} < 0.95")
        reload_s = _filtered_and_reload(c, name, q_host, ids_hr)
    finally:
        channel.close()
        server.stop(None)
    return {"index": records, "edge_recall": recall, "edge_p50_ms": p50,
            "reload_s": reload_s, "popcount_ms": pop_ms, "pm1_ms": mm_ms,
            "pm1_exact_ms": ex_ms}


def phase_pq(tmp, device="cuda"):
    """Phase 6: an edge PQ collection at 1M x 768 and its ADC store."""
    import torch
    from coltt_tpu_torch import bench, bench_pq
    from coltt_tpu_torch.ops import fused_scan as fs
    from coltt_tpu_torch.ops.pq import pq_reconstruct
    from coltt_tpu_torch.ops.quant import Quantization
    from coltt_tpu_torch.ops.topk import compute_recall
    from coltt_tpu_torch.store.flat import FlatStore, pq_cache_rows

    dev = torch.device(device)
    t0 = time.perf_counter()
    g, centers, spectrum = bench_pq.make_centers(SEED, dev)
    gq = torch.Generator(device=dev).manual_seed(SEED + 1)
    queries = bench_pq.rows_of(gq, centers, spectrum, QUERIES)
    x = bench_pq.rows_of(g, centers, spectrum, SERVING_N)
    truth = bench.merge_truth(None, queries, x, 0)[1].cpu().numpy()
    x_host, q_host = x.cpu().numpy(), queries.cpu().numpy()
    del x
    log(f"[pq] {SERVING_N} x {DIM} mixture rows (spectrum i^-0.5) made and "
        f"ground-truthed: {time.perf_counter() - t0:.2f} s")

    server, channel, engine, c = _grpc_server(tmp, device)
    try:
        name = "pq"
        _ingest(c, name, x_host, Quantization.PQ)
        del x_host
        fs.reset_launch_counts()  # this path's counts
        loop_key = ("float8_e4m3fn", fs.LOOP_BF16)
        t0 = time.perf_counter()
        ids_hr = _batch_ids(c, name, q_host, True)
        first_s = time.perf_counter() - t0
        check(fs.binmax_scan.launches_by.get(loop_key, 0) > 0,
              "pq: high_resource SearchBatch did not launch K1's bf16 loop on f8")
        store = engine._collections[name].store
        cb = store.codebook
        check(cb is not None and cb.rotation is not None and cb.m == 96
              and cb.n_centroids == 256, "pq: codebook not trained as configured")
        log(f"[pq] first SearchBatch (trains M=96 K=256 OPQ 4 on the first sync, "
            f"encodes {SERVING_N} rows, builds the f8 cache): {first_s:.2f} s")
        ids_plain = _batch_ids(c, name, q_host, False)
        p50 = {hr: _sync_p50(lambda: c.search_batch(name, q_host, limit=K,
                                                      high_resource=hr))
               for hr in (True, False)}
        # the edge path's counts: the SearchBatches above and nothing else
        k1_by = dict(fs.binmax_scan.launches_by)
        launches = fs.binmax_scan.launches

        # the yardstick: exact ADC, every row reconstructed in f32
        qr = cb.rotate(queries)
        qn = torch.nn.functional.normalize(qr, dim=1)
        best = None
        for lo in range(0, SERVING_N, 1 << 17):
            rec = pq_reconstruct(store.pqcodes[lo:min(SERVING_N, lo + (1 << 17))], cb)
            v, i = torch.topk(qn @ torch.nn.functional.normalize(rec, dim=1).t(), K, dim=1)
            i = i + lo
            if best is not None:
                v, sel = torch.topk(torch.cat([best[0], v], 1), K, dim=1)
                i = torch.gather(torch.cat([best[1], i], 1), 1, sel)
            best = (v, i)
        adc_truth = best[1].cpu().numpy()

        adc_store = FlatStore.adopt_pq(cb, store.pqcodes[:SERVING_N], pq_cache=False,
                                       device=dev)
        _, ids_adc = adc_store.search(q_host, K)
        # the same codes with the code table on the host: the collection's
        # snapshot loaded with pq_host_codes, searched as high_resource
        snap = io.BytesIO()
        store.save(snap)
        host_store = FlatStore.load(io.BytesIO(snap.getvalue()), device=dev,
                                    pq_host_codes=True)
        del snap
        check(host_store.pq_host and host_store.pqcodes is None,
              "pq: the host-codes store keeps its code table on the card")
        _, ids_host = host_store.search(q_host, K, fused=True, oversample=OVERSAMPLE)
        del host_store
        recalls = {}
        for what, ids in (("high_resource (K1 f8 + rerank)", ids_hr),
                          ("plain (f8 scan + rerank)", ids_plain),
                          ("ADC (pq_cache=False)", ids_adc),
                          ("host codes (K1 f8 + host-gathered rerank)", ids_host)):
            r_adc, r_f32 = compute_recall(ids, adc_truth), compute_recall(ids, truth)
            recalls[what] = {"vs_exact_adc": r_adc, "vs_f32": r_f32}
            log(f"[pq] {what}: recall@{K} vs exact ADC {r_adc:.4f}, vs f32 {r_f32:.4f}")
            check(r_adc >= 0.95, f"pq {what}: recall vs exact ADC {r_adc} < 0.95")

        # the store-level searches below count their own K1 launches
        fs.reset_launch_counts()
        q_batches = [bench_pq.rows_of(gq, centers, spectrum, QUERIES).cpu().numpy()
                     for _ in range(bench_pq.DEPTH)]
        store_qps = {
            "f8cache K1": bench_pq._public(bench_pq.measure(
                store, q_host, adc_truth, q_batches, fused=True, oversample=OVERSAMPLE)),
            "adc": bench_pq._public(bench_pq.measure(adc_store, q_host, adc_truth,
                                                     q_batches))}
        log(f"[pq] edge SearchBatch Q={QUERIES} p50: high_resource {p50[True]:.1f} "
            f"ms, plain {p50[False]:.1f} ms; store searches (recall vs exact ADC): "
            f"{json.dumps(store_qps)}")
        prof = None
        if dev.type == "cuda":
            prof = {"f8cache K1": bench.profile_round(lambda: [
                        store.search(q, K, fused=True, oversample=OVERSAMPLE)
                        for q in q_batches]),
                    "adc": bench.profile_round(lambda: [
                        adc_store.search(q, K) for q in q_batches[:2]])}
            log(f"[pq] one round of {len(q_batches)} high_resource store searches and "
                f"one of 2 ADC store searches (Q={QUERIES}) under torch.profiler: "
                f"{json.dumps(prof)}")
            torch.cuda.synchronize()
        store_launches = fs.binmax_scan.launches
        del adc_store
        t0 = time.perf_counter()
        pq_cache_rows(store.pqcodes, cb)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        log(f"[pq] f8 cache rebuild of {SERVING_N} rows: {rebuild_s:.3f} s")
        del store
        reload_s = _filtered_and_reload(c, name, q_host, ids_hr)
    finally:
        channel.close()
        server.stop(None)
    return {"recalls": recalls, "p50_ms": p50, "store": store_qps, "profile": prof,
            "rebuild_s": rebuild_s, "reload_s": reload_s, "k1_by_loop": k1_by,
            "k1_launches": launches, "k1_launches_store_searches": store_launches}


# -- phase 7 -------------------------------------------------------------------

def _kernel_class(name: str) -> str:
    """A profiled kernel's part of a CFLAT search: the per-field products
    (cuBLAS), the selection (top-k and sorts), or an elementwise pass of
    the epilogue and the weighted sum."""
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet")):
        return "products"
    if any(s in low for s in ("topk", "sort", "radix")):
        return "selection"
    return "elementwise"


def _same_row(single, batch, what):
    """A query searched alone (k hits) equals its batch row, fetched with
    k + 1 hits: scores within 1e-3, ids equal except where two
    neighbouring batch scores, the (k+1)-th included, are within 1e-3 of
    each other (the two sums run over other shapes)."""
    (s1, i1), (sb, ib) = single, batch
    k = len(s1)
    check(len(sb) == k + 1, f"{what}: the batch row needs k + 1 hits")
    check(np.allclose(s1, sb[:k], rtol=0, atol=1e-3), f"{what}: scores {s1} != {sb[:k]}")
    for r in np.nonzero(np.asarray(i1) != np.asarray(ib[:k]))[0]:
        near = [abs(sb[r] - sb[j]) <= 1e-3 for j in (r - 1, r + 1) if 0 <= j < len(sb)]
        check(any(near), f"{what}: id at rank {r} differs")


def _product_times(q, codes):
    """ms of one field's [Q, D] x [D, N] product with bf16 operands and an
    f32 result, the two forms: both operands widened back to f32 (the plain
    scan's form, exact products summed in f32, TF32 off) and
    ``torch.mm(..., out_dtype=torch.float32)`` on the bf16 operands; each
    with the operands' conversion from the stored codes, and without it.
    Returns the times and the largest difference between the two
    results."""
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    qb, cb = q.to(bf), codes.to(bf)
    qw, cw = qb.to(f32), cb.to(f32)
    diff = float((torch.mm(qb, cb.t(), out_dtype=f32) - qw @ cw.t()).abs().max())
    ms = timed(lambda: q.to(bf).to(f32) @ codes.to(bf).to(f32).t(),
               lambda: torch.mm(q.to(bf), codes.to(bf).t(), out_dtype=f32),
               lambda: qw @ cw.t(),
               lambda: torch.mm(qb, cb.t(), out_dtype=f32))
    return dict(max_abs_diff=diff, widened_ms=ms[0], out_dtype_ms=ms[1],
                widened_product_only_ms=ms[2], out_dtype_product_only_ms=ms[3])


def phase_cflat(tmp, device="cuda"):
    """Phase 7: CFLAT at the bench's size, then the experimental server."""
    import torch
    from coltt_tpu_torch import bench
    from coltt_tpu_torch import bench_cflat as bc
    from coltt_tpu_torch.index.schema import CollectionSchema, FieldSchema, FieldType
    from coltt_tpu_torch.ops import fused_scan as fs
    from coltt_tpu_torch.ops.quant import Quantization, dequantize
    from coltt_tpu_torch.ops.topk import compute_recall, fetch_scores_ids

    dev = torch.device(device)
    fs.reset_launch_counts()  # this path's counts: CFLAT runs neither kernel
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = bc.make_rows(CFLAT_N, gen)
    store = bc.build_store(rows, dev)
    width = sum(bc.FIELDS.values())
    queries = torch.randn((CFLAT_Q, width), generator=gen, device=dev)
    q_batches = [torch.randn((CFLAT_Q, width), generator=gen, device=dev)
                 for _ in range(bc.DEPTH)]
    qf = dict(zip(bc.FIELDS, bc.split(queries)))
    q_host = {f: q.cpu().numpy() for f, q in qf.items()}
    log(f"[cflat] {CFLAT_N} x {bc.FIELDS} gaussian rows made on the card, F8 "
        f"store through multivec_store_from_arrays from device tensors: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    # k + 1 hits, so that a single search's last hit is checked too
    scores1, slots1 = store.search_batch(
        [(f, q_host[f], bc.RATIOS[f]) for f in bc.FIELDS], K + 1)
    first_s = time.perf_counter() - t0
    scores, slots = scores1[:, :K], slots1[:, :K]
    check(scores.shape == (CFLAT_Q, K) and np.isfinite(scores).all(),
          "cflat: non-finite or misshapen scores")
    check(((slots >= 0) & (slots < CFLAT_N)).all(), "cflat: a slot past the records")
    check((scores[:, :-1] >= scores[:, 1:]).all(), "cflat: scores not descending")
    deq_truth = bc.weighted_truth(
        qf, lambda f, lo, hi: dequantize(store.codes[f][lo:hi], store.scale[f][lo:hi]),
        CFLAT_N)
    f32_truth = bc.weighted_truth(qf, lambda f, lo, hi: rows[f][lo:hi], CFLAT_N)
    r_deq, r_f32 = compute_recall(slots, deq_truth), compute_recall(slots, f32_truth)
    log(f"[cflat] search_batch Q={CFLAT_Q} ratios 70/30 (first {first_s:.2f} s): "
        f"recall@{K} {r_deq:.4f} vs the f32 weighted sum of the dequantized codes, "
        f"{r_f32:.4f} vs the f32 rows")
    check(r_deq >= 0.95, f"cflat: recall {r_deq} < 0.95 vs the dequantized sum")
    for r in range(4):
        single = store.search([(f, q_host[f][r], bc.RATIOS[f]) for f in bc.FIELDS], K)
        _same_row(single, (scores1[r], slots1[r]), f"cflat query {r}")
    dispatch = bc.dispatcher(store)
    warmup_s, p50_ms, qps, qps_rounds = bench.time_dispatch(dispatch, q_batches)
    log(f"[cflat] store, Q={CFLAT_Q} queued depth {bc.DEPTH}: {qps:.1f} QPS (rounds "
        f"{[round(x, 1) for x in qps_rounds]}), p50 {p50_ms:.3f} ms; search == "
        f"its batch row for 4 queries")
    prof = None
    if dev.type == "cuda":
        prof = bench.profile_round(
            lambda: [fetch_scores_ids(*dispatch(q)) for q in q_batches], top=64)
        parts = {}
        for name, ms in prof["device_ms_by_kernel"].items():
            parts[_kernel_class(name)] = round(parts.get(_kernel_class(name), 0.0) + ms, 3)
        prof["device_ms_by_part"] = parts
        log(f"[cflat] one queued round of {bc.DEPTH} x {CFLAT_Q} queries under "
            f"torch.profiler: {json.dumps(prof)}")
        product = _product_times(qf["semantic"], store.codes["semantic"])
        log(f"[cflat] the semantic field's product, Q={CFLAT_Q} x N={CFLAT_N} x "
            f"D=768, f8 codes, bf16 operands, f32 result: {json.dumps(product)}")
    else:
        product = None
    del store, rows, q_batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (b) the experimental server over gRPC
    server, channel, engine, c = _grpc_server(tmp, device, mode="experimental")
    try:
        name = "cflat"
        fields = ("semantic_vec", "title_vec")
        ratios = dict(zip(fields, (70.0, 30.0)))
        c.create_collection(CollectionSchema(
            name=name, dim=DIM, quantization=Quantization.F8,
            fields=[FieldSchema(f, FieldType.VECTOR) for f in fields]
            + [FieldSchema("tag", FieldType.STRING)]))
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        x = {f: torch.randn((GRPC_CFLAT_N, DIM), generator=g, device=dev).cpu().numpy()
             for f in fields}
        qs = {f: torch.randn((CFLAT_Q, DIM), generator=g, device=dev).cpu().numpy()
              for f in fields}
        t0 = time.perf_counter()
        for lo in range(0, GRPC_CFLAT_N, GRPC_CFLAT_CHUNK):
            hi = min(GRPC_CFLAT_N, lo + GRPC_CFLAT_CHUNK)
            c.bulk_index(name, [str(i) for i in range(lo, hi)],
                         {f: x[f][lo:hi] for f in fields},
                         [{"tag": f"t{i % TAGS}"} for i in range(lo, hi)])
        ingest_s = time.perf_counter() - t0
        check(c.get_collection(name).collection_size == GRPC_CFLAT_N,
              "cflat: size after BulkIndex")
        log(f"[cflat] BulkIndex {GRPC_CFLAT_N} records x 2 x {DIM}d in "
            f"{GRPC_CFLAT_N // GRPC_CFLAT_CHUNK} RPCs: {ingest_s:.2f} s = "
            f"{GRPC_CFLAT_N / ingest_s:.0f} rows/s (each RPC quantizes its rows "
            f"on the card)")
        del x

        query = [(f, qs[f], True, ratios[f]) for f in fields]

        def batch_ids(qf_, k=K):
            counts, scores_, ids, _ = c.vector_search_batch(name, qf_, top_k=k)
            check(counts == [k] * CFLAT_Q, f"cflat: counts {set(counts)}")
            s = np.asarray(scores_).reshape(CFLAT_Q, k)
            check(np.isfinite(s).all() and (s[:, :-1] >= s[:, 1:]).all(),
                  "cflat: VectorSearchBatch scores not finite and descending")
            return s, np.array([int(p) for p in ids]).reshape(CFLAT_Q, k)

        s_b1, ids_b1 = batch_ids(query, K + 1)  # k + 1: see _same_row
        s_b, ids_b = s_b1[:, :K], ids_b1[:, :K]
        store = engine._collections[name].store
        truth = bc.weighted_truth(
            {f: torch.from_numpy(qs[f]).to(dev) for f in fields},
            lambda f, lo, hi: dequantize(store.codes[f][lo:hi], store.scale[f][lo:hi]),
            GRPC_CFLAT_N, ratios=ratios)
        recall = compute_recall(ids_b, truth)
        log(f"[cflat] VectorSearchBatch Q={CFLAT_Q} ratios 70/30: recall@{K} "
            f"{recall:.4f} vs the f32 weighted sum of the dequantized codes")
        check(recall >= 0.95, f"cflat: VectorSearchBatch recall {recall} < 0.95")
        for r in range(3):
            hits = c.vector_search(name, [(f, qs[f][r], True, ratios[f]) for f in fields],
                                   top_k=K)
            _same_row((np.array([h["score"] for h in hits]),
                       np.array([int(h["id"]) for h in hits])),
                      (s_b1[r], ids_b1[r]), f"cflat VectorSearch {r}")
        only = batch_ids([(fields[0], qs[fields[0]], True, 100.0)])
        off = batch_ids([(fields[0], qs[fields[0]], True, 100.0),
                         (fields[1], qs[fields[1]], False, 0.0)])
        check((only[1] == off[1]).all() and (only[0] == off[0]).all(),
              "cflat: an include_or_not=false field changed the result")
        victim = str(ids_b[0, 0])
        c.index(name, victim, delete=True)
        s_d, ids_d = batch_ids(query)
        check(int(victim) not in ids_d, "cflat: a deleted id came back")
        check(ids_d[0, 0] == ids_b[0, 1], "cflat: query 0's second hit did not move up")
        t0 = time.perf_counter()
        c.flush(name)
        c.release_collection(name)
        check(not c.get_collection(name).load, "cflat: still loaded")
        c.load_collection(name)
        reload_s = time.perf_counter() - t0
        check((batch_ids(query)[1] == ids_d).all(),
              "cflat: VectorSearchBatch after reload returned other ids")
        log(f"[cflat] VectorSearch == its batch row (3 queries), include_or_not=false "
            f"== field left out, a deleted id gone from every result, Flush + "
            f"Release + Load {reload_s:.2f} s: same ids")
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            c.vector_search_batch(name, query, top_k=K)
            ts.append(time.perf_counter() - t0)
        grpc_p50 = statistics.median(ts) * 1e3
        grpc_qps = CFLAT_Q * REPS / sum(ts)
        log(f"[cflat] VectorSearchBatch Q={CFLAT_Q} over gRPC, {REPS} in a row: "
            f"p50 {grpc_p50:.1f} ms, {grpc_qps:.1f} QPS")
    finally:
        channel.close()
        server.stop(None)
    launches = {"K1": fs.binmax_scan.launches, "K2": fs.binmax_scan_i8.launches}
    check(launches == {"K1": 0, "K2": 0}, f"cflat: launched {launches}")
    return {"store": {"recall_deq": r_deq, "recall_f32": r_f32, "qps": qps,
                      "p50_ms": p50_ms, "warmup_s": warmup_s, "profile": prof,
                      "product": product},
            "grpc": {"ingest_rows_per_s": GRPC_CFLAT_N / ingest_s, "recall": recall,
                     "p50_ms": grpc_p50, "qps": grpc_qps, "reload_s": reload_s},
            "launches": launches}


# -- phase 8 -------------------------------------------------------------------

def _core_part(name: str) -> str:
    """A profiled kernel's part of an HNSW search: the batched products,
    the row gathers (indexing), the selections (sorts, top-k, searchsorted)
    or an elementwise pass (reductions included); copies apart."""
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "bmm")):
        return "products"
    if any(s in low for s in ("sort", "topk", "radix", "searchsorted", "bitonic")):
        return "selections"
    if any(s in low for s in ("index", "gather", "scatter")):
        return "gathers"
    return "elementwise"


def _search_truth(idx, queries, dev):
    """Exact cosine top-k over the index's live rows (its host f32 rows,
    tombstones masked), an f32 scan on the card with TF32 off."""
    import torch
    from coltt_tpu_torch.ops.distance import Metric
    from coltt_tpu_torch.ops.topk import scan_neg_topk

    n = idx._next
    rows = torch.from_numpy(idx._vecs[:n]).to(dev)
    _, ids = scan_neg_topk(torch.from_numpy(queries).to(dev), rows, None,
                           (rows * rows).sum(dim=1), torch.from_numpy(idx._alive[:n]).to(dev),
                           k=K, metric=Metric.COSINE, compute_dtype=torch.float32)
    return ids.cpu().numpy()


def _same_search(single, batch_row, what, tol=1e-5):
    """A query searched alone equals its row of the batch: distances within
    ``tol`` (the batched products may sum in another order), ids equal
    except between two distances within ``tol`` of each other."""
    (d1, i1), (db, ib) = single, batch_row
    check(np.allclose(d1, db, rtol=0, atol=tol), f"{what}: distances {d1} != {db}")
    for r in np.nonzero(np.asarray(i1) != np.asarray(ib))[0]:
        near = [abs(db[r] - db[j]) <= tol for j in (r - 1, r + 1) if 0 <= j < len(db)]
        check(any(near), f"{what}: id at rank {r} differs")


def _core_store(dev):
    """Phase 8a: the HNSW store at bench_hnsw's recipe, bf16 device graph."""
    import torch
    from coltt_tpu_torch import bench
    from coltt_tpu_torch import bench_hnsw as bh
    from coltt_tpu_torch.ops.topk import compute_recall
    from coltt_tpu_torch.store.hnsw import HnswIndex

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, centers = bh.make_corpus(CORE_N, CORE_DIM, gen)
    vecs = rows.cpu().numpy()
    eval_q = bh.make_queries(CORE_Q, centers, gen)
    q_batches = [bh.make_queries(CORE_Q, centers, gen) for _ in range(CORE_DEPTH)]
    extra = bh.make_queries(4096, centers, gen)
    del rows
    log(f"[core] {CORE_N} x {CORE_DIM} mixture rows ({bh.N_CENTERS} centres, sigma "
        f"{bh.SIGMA}) made on the card: {time.perf_counter() - t0:.2f} s")

    idx = HnswIndex(CORE_DIM, config=bh.CONFIG, device_dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    idx.bulk_build_auto(vecs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[core] bulk_build_auto ({bh.CONFIG}): {build_s:.2f} s = "
        f"{CORE_N / build_s:.1f} rows/s")

    truth = _search_truth(idx, eval_q, dev)
    t0 = time.perf_counter()
    d_b, i_b = idx.search(eval_q, K)
    first_s = time.perf_counter() - t0
    recall = float(compute_recall(i_b, truth))
    check(np.isfinite(d_b).all() and ((i_b >= 0) & (i_b < CORE_N)).all(),
          "core: a missing or out-of-range hit")
    check((d_b[:, :-1] <= d_b[:, 1:]).all(), "core: distances not ascending")
    log(f"[core] search Q={CORE_Q} k={K} ef={bh.CONFIG.ef} (first {first_s:.2f} s): "
        f"recall@{K} {recall:.4f} vs the f32 scan")
    check(recall >= 0.90, f"core: recall {recall} < 0.90")
    for r in range(4):
        d1, i1 = idx.search(eval_q[r], K)
        _same_search((d1[0], i1[0]), (d_b[r], i_b[r]), f"core query {r}")
    p50_ms, qps, rounds = bh.search_rounds(idx, q_batches, warm=1, rounds=3)
    log(f"[core] {CORE_DEPTH} batches of {CORE_Q} a round: {qps:.1f} QPS (rounds "
        f"{[round(x, 1) for x in rounds]}), p50 {p50_ms:.3f} ms")
    forms = bh.loop_forms(idx, q_batches, eval_q)
    log(f"[core] loop forms (exit check every {forms['check_every']} hops vs the "
        f"fixed count, in turns): {json.dumps(forms)}")
    check(forms["ids_equal"] and forms["dists_equal"],
          "core: the fixed-count and early-exit loops disagree")
    prof = None
    if dev.type == "cuda":
        prof = bench.profile_round(lambda: [idx.search(q, K) for q in q_batches], top=80)
        parts = {}
        for name, ms in prof["device_ms_by_kernel"].items():
            parts[_core_part(name)] = round(parts.get(_core_part(name), 0.0) + ms, 3)
        prof["device_ms_by_part"] = parts
        log(f"[core] one round of {CORE_DEPTH} x {CORE_Q} queries under torch.profiler: "
            f"{json.dumps(prof)}")

    victims = [int(i_b[r, 0]) for r in range(4)]
    for v in victims:
        check(idx.remove(v), f"core: remove({v}) refused")
    for _ in range(2):
        _, ids = idx.search(eval_q, K)
        check(not set(victims) & set(ids.ravel().tolist()), "core: a deleted slot came back")
    # one round of 2 batches: a search racing the writer thread for the
    # interpreter lock takes seconds (PERF.md section 5)
    mutate = bh.mutate_qps(idx, q_batches[:2], extra, warm=0, rounds=1)
    truth = _search_truth(idx, eval_q, dev)
    recall_mut = float(compute_recall(idx.search(eval_q, K)[1], truth))
    log(f"[core] deleted slots gone; interleaved mutate/search: {mutate['qps']:.1f} QPS, "
        f"p50 {mutate['p50_ms']:.3f} ms, {mutate['inserts']} inserts; recall@{K} after "
        f"{recall_mut:.4f} vs the f32 scan of the live rows")
    check(recall_mut >= 0.90, f"core: recall {recall_mut} < 0.90 after mutation")
    return {"rows": CORE_N, "build_s": build_s, "build_rows_per_s": CORE_N / build_s,
            "recall": recall, "qps": qps, "p50_ms": p50_ms, "loop_forms": forms,
            "profile": prof, "mutate": mutate, "recall_after_mutate": recall_mut}


def _crash(engine):
    """Stop a core engine as a crash would: the commit log stays as written,
    no snapshot, no hint; the directory lock is released."""
    import fcntl

    kv = engine.kv
    kv._stop.set()
    kv._wal.sync()
    fcntl.flock(kv._lock_f, fcntl.LOCK_UN)
    kv._lock_f.close()


def _core_server(tmp, dev):
    """Phase 8b: --mode root in process, f32 graph, over gRPC."""
    import torch
    from coltt_tpu_torch import bench_hnsw as bh
    from coltt_tpu_torch.ops.topk import compute_recall

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    rows, centers = bh.make_corpus(CORE_GRPC_N, CORE_DIM, gen)
    x = rows.cpu().numpy()
    queries = bh.make_queries(CORE_Q, centers, gen)
    fresh = bh.make_queries(CORE_INSERTS, centers, gen)
    truth = bh.ground_truth(queries, rows)
    del rows
    name = "core"
    ids = [f"{i:07d}" for i in range(CORE_GRPC_N)]  # key order = row order

    def batch(c, q=queries):
        counts, scores, got, _, _ = c.vector_search_batch(name, q, top_k=K)
        check(counts == [K] * len(q), f"core: VectorSearchBatch counts {set(counts)}")
        s = np.asarray(scores).reshape(len(q), K)
        check(np.isfinite(s).all() and (s[:, :-1] >= s[:, 1:]).all(),
              "core: VectorSearchBatch scores not finite and descending")
        return s, np.asarray(got).reshape(len(q), K)

    server, channel, engine, c = _grpc_server(tmp, dev.type, mode="root")
    try:
        c.create_collection(name, CORE_DIM, config=bh.CONFIG)
        t0 = time.perf_counter()
        c.bulk_insert(name, x, [{"tag": f"t{i % TAGS}"} for i in range(CORE_GRPC_N)],
                      ext_ids=ids)
        bulk_s = time.perf_counter() - t0
        check(c.collection_info(name).info.collection_length == CORE_GRPC_N,
              "core: size after BulkInsert")
        log(f"[core-grpc] BulkInsert {CORE_GRPC_N} x {CORE_DIM} in one RPC "
            f"(bulk_build_auto, f32 device graph): {bulk_s:.2f} s = "
            f"{CORE_GRPC_N / bulk_s:.1f} rows/s")
        s_before, ids_before = batch(c)
        recall = float(compute_recall(np.vectorize(int)(ids_before), truth))
        log(f"[core-grpc] VectorSearchBatch Q={CORE_Q}: recall@{K} {recall:.4f} vs "
            f"the f32 scan")
        check(recall >= 0.90, f"core: VectorSearchBatch recall {recall} < 0.90")
    finally:
        channel.close()
        server.stop(None)
    _crash(engine)
    del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    server, channel, engine, c = _grpc_server(tmp, dev.type, mode="root")
    try:
        t0 = time.perf_counter()
        c.load_collection(name)
        replay_s = time.perf_counter() - t0
        check(c.collection_info(name).info.collection_length == CORE_GRPC_N,
              "core: size after the restart")
        s_after, ids_after = batch(c)
        check((ids_after == ids_before).all(), "core: the restart returned other ids")
        check(np.allclose(s_after, s_before, rtol=0, atol=1e-4),
              "core: the restart returned other scores")
        log(f"[core-grpc] stopped without a snapshot; a new server rebuilt the "
            f"collection from the KV commit log in {replay_s:.2f} s: same ids")
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            batch(c)
            ts.append(time.perf_counter() - t0)
        p50 = statistics.median(ts) * 1e3

        t0 = time.perf_counter()
        for i in range(CORE_INSERTS):
            c.insert(name, fresh[i], {"tag": "new"}, ext_id=f"n{i:05d}")
        insert_s = time.perf_counter() - t0
        check(c.collection_info(name).info.collection_length == CORE_GRPC_N + CORE_INSERTS,
              "core: size after the Inserts")
        log(f"[core-grpc] {CORE_INSERTS} one-by-one Inserts: {insert_s:.2f} s = "
            f"{CORE_INSERTS / insert_s:.1f} rows/s; VectorSearchBatch p50 {p50:.1f} ms")

        s_b, ids_b = batch(c)
        for r in range(3):
            hits, _ = c.vector_search(name, queries[r], top_k=K)
            check([h["id"] for h in hits] == ids_b[r].tolist(),
                  f"core: VectorSearch {r} != its batch row")
            check(np.allclose([h["score"] for h in hits], s_b[r], rtol=0, atol=1e-4),
                  f"core: VectorSearch {r} scores != its batch row")
        hits, _ = c.vector_search(name, fresh[7], top_k=1)
        check(hits[0]["id"] == "n00007", "core: an Insert is not found by its vector")
        hits, _ = c.filter_search(name, {"tag": "t3"}, top_k=K, vector=queries[0])
        check(len(hits) == K and all(h["metadata"]["tag"] == "t3"
                                     and int(h["id"]) % TAGS == 3 for h in hits),
              "core: FilterSearch returned rows outside the tag")
        hits, _ = c.hybrid_search(name, queries[1], {"tag": "t5"}, top_k=K)
        check(hits and all(h["metadata"]["tag"] == "t5" and int(h["id"]) % TAGS == 5
                           for h in hits), "core: HybridSearch returned rows outside the tag")
        moved = ids_b[2, 0]
        c.update(name, moved, fresh[0] * 3.0, {"tag": "moved"})
        hits, _ = c.vector_search(name, fresh[0] * 3.0, top_k=2)
        check({h["id"] for h in hits} == {moved, "n00000"},
              "core: an Update did not show in later results")
        victim = ids_b[0, 0]
        c.delete(name, victim)
        s_d, ids_d = batch(c)
        check(victim not in ids_d and moved not in ids_d[2],
              "core: a deleted or moved id came back")
        same = c.compare_dist(queries[0], queries[0])
        check(abs(same - 100.0) <= 1e-3, f"core: CompareDist(x, x) = {same}, not 100")
        t0 = time.perf_counter()
        c.release_collection(name)
        check(not engine.state.loaded(name), "core: still loaded after Release")
        c.load_collection(name)
        reload_s = time.perf_counter() - t0
        check((batch(c)[1] == ids_d).all(), "core: Release + Load returned other ids")
        log(f"[core-grpc] VectorSearch == its batch row (3 queries); FilterSearch and "
            f"HybridSearch on a tag; Update and Delete show; CompareDist(x, x) = 100; "
            f"Release (snapshot) + Load {reload_s:.2f} s: same ids")
    finally:
        channel.close()
        server.stop(None)
        engine.close()
    return {"rows": CORE_GRPC_N, "bulk_rows_per_s": CORE_GRPC_N / bulk_s,
            "recall": recall, "p50_ms": p50, "replay_s": replay_s,
            "insert_rows_per_s": CORE_INSERTS / insert_s, "reload_s": reload_s}


def phase_core(tmp, device="cuda"):
    """Phase 8: core mode, the HNSW store (8a) and the root server (8b)."""
    import torch
    from coltt_tpu_torch import native
    from coltt_tpu_torch.ops import fused_scan as fs

    dev = torch.device(device)
    log(f"[core] commit log framing / replay: {native.describe()}")
    fs.reset_launch_counts()  # this path's counts: core mode runs neither kernel
    store = _core_store(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    grpc_run = _core_server(tmp, dev)
    launches = {"K1": fs.binmax_scan.launches, "K2": fs.binmax_scan_i8.launches}
    check(launches == {"K1": 0, "K2": 0}, f"core: launched {launches}")
    return {"store": store, "grpc": grpc_run, "launches": launches}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    try:
        import coltt_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout (coltt_tpu_torch "
              "not found)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tmp = tempfile.mkdtemp(prefix="coltt-smoke-")
    try:
        phase_card()
        phase_build()
        k1_records = phase_kernels()
        k2_record = phase_k2()
        data = make_data()
        run = phase_server(tmp, data)
        index_run = phase_flat_index(data, run["recall_k1"])
        frontier_run = phase_frontier(data, index_run.pop("i8"))
        sharded_run = phase_sharded(tmp, data, run, index_run)
        del data
        bq_run = phase_bq(os.path.join(tmp, "bq"))
        pq_run = phase_pq(os.path.join(tmp, "pq"))
        cflat_run = phase_cflat(os.path.join(tmp, "cflat"))
        core_run = phase_core(os.path.join(tmp, "core"))
        quickstart_run = phase_quickstart(os.path.join(tmp, "quickstart"))
    except Exception:  # noqa: BLE001 — any failure fails the smoke
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # launches: the flat-index path (phase 4); each path's own count beside
    for rec in k1_records:
        key = (rec["codes"], rec["loop"])
        rec["launches_by_path"] = {"edge_server": run["k1_by_loop"].get(key, 0),
                                   "flat_index": index_run["k1_by_loop"].get(key, 0),
                                   "frontier": frontier_run["k1_by_loop"].get(key, 0),
                                   "edge_pq": pq_run["k1_by_loop"].get(key, 0),
                                   "sharded": sharded_run["k1_by_loop"].get(key, 0)}
        rec["launches"] = rec["launches_by_path"]["flat_index"]
    top = next(r for r in k1_records if r["loop"] == "int8-wgmma" and r["q"] == QUERIES)
    kernels = [{
        "name": "K1 binmax_scan",
        "route": "cuda",
        "source": top["source"],
        "replaces": "coltt_tpu/ops/scan_pallas.py:126",
        "launches": index_run["launches"]["K1"],
        "launches_by_path": {"edge_server": run["launches"]["K1"],
                             "flat_index": index_run["launches"]["K1"],
                             "frontier": frontier_run["launches"]["K1"],
                             "edge_pq": pq_run["k1_launches"],
                             "sharded": sharded_run["launches"]["K1"],
                             "cflat": cflat_run["launches"]["K1"],
                             "core": core_run["launches"]["K1"]},
        **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                               "bound_ms", "bound_by", "share_of_bound")},
        "loops": k1_records,
    }, {
        "name": "K2 binmax_scan_i8",
        "route": "cuda",
        "source": "coltt_tpu_torch/csrc/binmax_scan.cu",
        "replaces": "coltt_tpu/ops/scan_pallas.py:559",
        "launches": index_run["launches"]["K2"],
        "launches_by_path": {"edge_server": run["launches"]["K2"],
                             "flat_index": index_run["launches"]["K2"],
                             "frontier": frontier_run["launches"]["K2"],
                             "sharded": sharded_run["launches"]["K2"],
                             "cflat": cflat_run["launches"]["K2"],
                             "core": core_run["launches"]["K2"]},
        **k2_record,
    }]
    log(json.dumps({"sharded": {k: v for k, v in sharded_run.items()
                                 if k != "k1_by_loop"},
                    "bq": bq_run, "pq": {k: v for k, v in pq_run.items()
                                          if k != "k1_by_loop"},
                    "cflat": cflat_run, "core": core_run,
                    "frontier": {k: v for k, v in frontier_run.items()
                                 if k != "k1_by_loop"},
                    "quickstart": quickstart_run},
                   default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-worker"]:  # a phase 9c process
        sys.exit(shard_worker(sys.argv[2:]))
    sys.exit(main())

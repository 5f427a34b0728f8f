"""Fused scan + top-k: the high-throughput FLAT search path.

Port of ``coltt_tpu/ops/scan_pallas.py``: K1 and its wrapper, the slot2
selection, and K2 with the unit-norm int8 path below. The plain
scan (:mod:`.topk`) materializes the ``[Q, N]`` f32 score matrix in device
memory: 8 GB at Q=2048, N=1M, ten times the int8 corpus. K1
(:func:`binmax_scan`, CUDA kernels in ``csrc/binmax_scan.cu`` for int8
codes and ``csrc/binmax_scan_float.cu`` for float codes) keeps each
score tile on chip and reduces it to one survivor per bin of 32 rows (16
when the store's row count is not a multiple of 4096), so only
``[Q, N/32]`` int32 keys reach device memory; an exact ``torch.topk``
over them finishes the selection.

The survivor is one packed int32 *monotone key*. A positivity bias B (a
Cauchy-Schwarz bound on |score|) rides in ``rowadd``, so every valid
score lands in ``(0, 2B]``, where the raw f32 bits order like the value.
The key is those bits with the bin's slice index in the low mantissa
bits (a ~2^-18-of-B perturbation, below quantization error); a plain
integer max reduces the slices (ties go to the higher slice), and the
winner's row id is rebuilt bit-wise after the selection. Tombstoned rows
carry a -3e38 penalty and lose to every valid row.

Per-query factors (query norm, the int8 query scale) leave the kernel:
they preserve the ranking within a query and are applied to the
``[Q, k]`` winners. For euclidean over int8 codes the query scale
multiplies only the dot term, so the batch shares one scalar scale.

The reduction keeps one survivor per bin, so two true top-k rows in one
bin lose the weaker one (pair collision probability bin/N: < 0.2% recall
at k=10, bin=32, N=1M).

Selection (``final``, :data:`FINALS`): ``"slot2"`` (:func:`_slot2_select`)
keeps the best two members of each strided slot of S bins and runs the
exact top-k over ``[Q, 2*nb/S]`` only; ``"exact"`` is an exact
``torch.topk`` over all the survivors. The reference's other names are
computed otherwise but give the same ids, so they are aliases here:

- ``"approx"`` / ``"auto"`` are the exact top-k: the reference's
  ``lax.approx_max_k`` is a TPU operation that is an exact top-k on the
  CPU, where the reference is checked.
- ``"approx2"`` is the exact top-k: the reference takes the top-k of each
  half of the bins (``approx_max_k`` again), then the top-k of the ``2k``
  candidates, which with exact halves is the exact top-k, ties aside.
- ``"slot2t"``, ``"slot2c"`` and ``"slot2a"`` are ``"slot2"``: the
  reference finds the same two survivors per slot by pairwise merges, by a
  linear min/max cascade, and by slot2's reduction with an
  ``approx_max_k`` tail. The member tags make the keys of a slot
  distinct, so the survivors are bit-identical to slot2's.

Separate paths for the aliases were only slower on the H100 (PERF.md,
the selection frontier).

Unit-norm int8 path (:func:`fused_unit_i8_neg_topk`): rows normalized and
quantized under ONE global scale, so the raw s8 x s8 -> s32 dot ranks
rows within a query and across stores. K2 (:func:`binmax_scan_i8`, in the
same CUDA source as K1) packs ``(dot << log2(nsl)) | slice`` and takes
an integer max; the wrapper masks dead bins, shifts every key by +2^30
into the non-negative range and selects on those int32 keys directly
(non-negative ints order like their f32 bits, which the reference
selects on). Callers rerank the shortlist (``ops/topk.rerank_neg_topk``).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from coltt_tpu_torch.ops.distance import Metric, int8_dot, quantize_queries_i8
from coltt_tpu_torch.ops.native import KernelLibrary, load_all
from coltt_tpu_torch.ops.topk import scores_from_negd

BIN_ROWS = 32     # max rows per candidate bin (chunk // _LANES)
_LANES = 128      # survivors per chunk = rows per slice
_CHUNK = 2048     # minimum chunk (shape-rule quantum); 4096 used when N allows
_QBLOCK = 512     # max query rows per block of the padded query batch
_PENALTY = -3.0e38
_INVALID_CUT = -1.0e30

# code dtype -> the number csrc/binmax_common.cuh gives it
_CODE_DTYPES = {
    torch.int8: 0,
    torch.float8_e4m3fn: 1,
    torch.bfloat16: 2,
    torch.float32: 3,
}
# bytes of [Q, rows] f32 transients the plain version keeps alive per step
_REF_STEP_BYTES = 1 << 28

_DEAD = -(1 << 30)  # K2 key of a bin with no valid row: below every real key
_UNIT_MAX_DIM = 2048  # |dot| <= 127^2 * D; << 5 must stay under 2^30

# the selections of the [Q, nb] bin survivors (the module docstring)
FINALS = ("auto", "exact", "approx", "approx2", "slot2", "slot2t", "slot2c",
          "slot2a")
_SLOT2 = ("slot2", "slot2t", "slot2c", "slot2a")  # the rest: exact top-k

_QTILES = (32, 64, 128)  # query tiles the int8 tensor-core loop is built for
_EXACT_QTILES = (16, 32, 64, 128)  # query tiles of K1's exact-f32 loop

# K1's bf16 loop (csrc/binmax_scan_float.cu, bf16_smem_bytes): the same
# constants, mirrored so that the plan is known before a launch
_KBLOCK = 64            # elements of D a ring stage carries
_RING_BUDGET = 64 * 1024  # ring bytes beside resident queries (x2 streamed)
_STAGING_STRIDE = _LANES + 4
_SMEM_OPTIN = 232_448   # shared memory an H100 block may opt into

# K1's loops, as binmax_scan routes a call
LOOP_INT8 = "int8-wgmma"   # int8 codes (csrc/binmax_scan.cu)
LOOP_BF16 = "bf16-wgmma"   # f8 / bf16 / f32 codes, bf16 operands
LOOP_F32 = "f32-simt"      # f8 / bf16 / f32 codes, exact f32 operands

# K1 (int8 loop) and K2; K1's float loops: built in parallel
_KERNELS = {"int8": KernelLibrary("binmax_scan"),
            "float": KernelLibrary("binmax_scan_float")}
_LAUNCHES_MU = threading.Lock()  # gRPC worker threads launch concurrently


def chunk_for(n: int) -> int:
    """Row chunk for an N-row store: the largest supported chunk dividing N.
    Everything deriving bin order (id reconstruction) uses this rule."""
    return 2 * _CHUNK if n % (2 * _CHUNK) == 0 else _CHUNK


def supports(n: int, dim: int, metric, dtype) -> bool:
    """Whether the fused kernel handles this store shape."""
    metric = Metric.parse(metric)
    return (
        metric in (Metric.COSINE, Metric.EUCLIDEAN)
        and dim % 128 == 0
        and n % _CHUNK == 0
        and dtype in _CODE_DTYPES
    )


def _pick_qblock(q: int, align: int) -> tuple[int, int]:
    """(padded q, block) — blocks of <=_QBLOCK rows, aligned, dividing qp.
    The padded batch is the shape K1 and its plain version take."""
    blocks = -(-q // _QBLOCK)
    per_block = -(-q // blocks)
    qblock = -(-per_block // align) * align
    return blocks * qblock, qblock


def int8_query_tile(qp: int) -> int:
    """Queries per block of the int8 tensor-core loop (K1 on int8 codes,
    K2): the least of 32, 64 and 128 that covers ``qp``, else 128 (a
    ragged last tile reads zero rows and stores nothing for them). The
    kernel keeps the tile resident in shared memory where it fits and
    streams it beside the codes where it does not, so any D runs."""
    return next((t for t in _QTILES if t >= qp), _QTILES[-1])


def bf16_smem_bytes(code_dtype, qtile: int, d: int, stream: bool) -> int:
    """Shared memory of K1's bf16 loop for a tile of ``qtile`` queries at
    width ``d``: as ``bf16_smem_bytes`` in ``csrc/binmax_scan_float.cu``
    lays it out (alignment slack, the resident query tile unless the
    queries stream, the TMA ring of 64-element k-blocks, the barriers)."""
    code = _LANES * _KBLOCK * code_dtype.itemsize
    stage = code + (qtile * 2 * _KBLOCK if stream else 0)
    stages = min(8, max(2, (2 if stream else 1) * _RING_BUDGET // stage))
    ring = max(stages * stage, qtile * _STAGING_STRIDE * 4)
    return 1024 + (0 if stream else qtile * d * 2) + ring + (2 * stages + 1) * 8


def bf16_query_tile(qp: int, d: int, code_dtype) -> tuple[int, bool]:
    """``(queries per block, stream)`` of K1's bf16 loop.

    The least of 32, 64 and 128 queries that covers ``qp`` (else 128),
    resident in shared memory where it fits beside the ring. A bf16 query
    row is twice an int8 one, so 128 resident queries fit only up to
    D=512; a larger batch then takes the widest of 96 and 64 that stays
    resident (96 at D=768: each code byte that a block reads from L2
    serves 96 queries). Where none does, the first tile streams its
    k-blocks through the ring beside the codes, so any D % 128 == 0 runs.
    """
    want = int8_query_tile(qp)
    tiles = (want, 96, 64) if want == 128 else (want,)
    for t in tiles:
        if bf16_smem_bytes(code_dtype, t, d, False) <= _SMEM_OPTIN:
            return t, False
    return want, True


def exact_query_tile(qp: int) -> int:
    """Queries per block of K1's exact-f32 loop: the least of 16, 32, 64
    and 128 that covers ``qp``, else 128 (each of 256 threads holds 2 x 4
    to 8 x 8 (query, bin) pairs: ``launch_f32`` in the C source)."""
    return next((t for t in _EXACT_QTILES if t >= qp), _EXACT_QTILES[-1])


def k1_loop(code_dtype, round_bf16: bool) -> str:
    """Which of K1's loops serves ``code_dtype`` codes: the int8 loop, the
    bf16 tensor-core loop (``round_bf16``: f8, bf16 and f32 codes under
    ``compute_dtype=bf16``) or the exact-f32 CUDA-core loop."""
    if code_dtype not in _CODE_DTYPES:
        raise TypeError(f"binmax_scan: unsupported code dtype {code_dtype}")
    if code_dtype == torch.int8:
        return LOOP_INT8
    return LOOP_BF16 if round_bf16 else LOOP_F32


def k1_plan(code_dtype, round_bf16: bool, qp: int, d: int) -> tuple[str, int, bool]:
    """``(loop, queries per block, stream)`` of a K1 call. The int8 loop
    decides resident against streamed itself (``stream`` is False here);
    the bf16 loop takes :func:`bf16_query_tile`'s choice."""
    loop = k1_loop(code_dtype, round_bf16)
    if loop == LOOP_INT8:
        return loop, int8_query_tile(qp), False
    if loop == LOOP_BF16:
        return (loop, *bf16_query_tile(qp, d, code_dtype))
    return loop, exact_query_tile(qp), False


def kernel_queries(queries, code_dtype, round_bf16: bool) -> torch.Tensor:
    """The query operand K1's loop reads, made on the queries' device.

    The bf16 loop takes the queries rounded to bf16 once. For f8 and f32
    codes (wgmma's A fragments widened in registers from the raw code
    tile) each 64-element k-block is permuted: kernel column 16j + 8h + 2t
    + e holds element 16t + 4j + 2h + e, so that each fragment thread
    reads one contiguous run of its code rows
    (``csrc/binmax_scan_float.cu``). The dot is a sum over D, so the
    permutation changes only its order. The other loops take ``queries``
    as they are.
    """
    if k1_loop(code_dtype, round_bf16) != LOOP_BF16:
        return queries
    qb = queries.to(torch.bfloat16)
    if code_dtype == torch.bfloat16:
        return qb.contiguous()
    qp, d = qb.shape
    # source element (t, j, h, e) of each k-block goes to (j, h, t, e)
    return (qb.view(qp, d // _KBLOCK, 4, 4, 2, 2).permute(0, 1, 3, 4, 2, 5)
            .reshape(qp, d).contiguous())


def load_kernels() -> dict:
    """Build (first use only, one ``nvcc`` per source, in parallel) and
    load the libraries of K1 and K2: ``{"int8": ..., "float": ...}``,
    whose ``build_seconds`` / ``build_log`` describe each build."""
    if all(lib.loaded for lib in _KERNELS.values()):
        return _KERNELS  # every launch passes here
    load_all(_KERNELS.values())
    int8 = _KERNELS["int8"].load()
    if int8.coltt_binmax_scan_s8.argtypes is None:
        fn = int8.coltt_binmax_scan_s8
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        k2 = int8.coltt_binmax_scan_i8
        k2.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        k2.restype = ctypes.c_int
        fl = _KERNELS["float"].load()
        fn = fl.coltt_binmax_scan_bf16
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = fl.coltt_binmax_scan_f32
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for lib in (int8, fl):
            lib.coltt_error_string.argtypes = [ctypes.c_int]
            lib.coltt_error_string.restype = ctypes.c_char_p
    return _KERNELS


def binmax_scan_ref(queries, codes, rowmul, rowadd, *, chunk: int,
                    round_bf16: bool) -> torch.Tensor:
    """Plain PyTorch version of K1: ``[qp, N // chunk * 128]`` int32 keys.

    Blocked over row chunks so that it never holds ``[Q, N]`` at once.
    The int8 product is exact (``torch._int_mm``); float codes are
    multiplied as f32 operands (bf16-rounded when ``round_bf16``) in an
    f32 product, which on CUDA needs TF32 off. The epilogue is one
    multiply and one add, each rounded, as in the kernel.
    """
    qp = queries.shape[0]
    n = codes.shape[0]
    nsl = chunk // _LANES
    out = torch.empty((qp, n // chunk * _LANES), dtype=torch.int32,
                      device=codes.device)
    slices = torch.arange(nsl, dtype=torch.int32, device=codes.device).view(
        1, 1, nsl, 1)
    step = max(1, _REF_STEP_BYTES // (qp * chunk * 4)) * chunk
    if codes.dtype == torch.int8:
        a = queries
    else:
        a = queries.to(torch.float32)
        if round_bf16:
            a = a.to(torch.bfloat16).to(torch.float32)
    for r0 in range(0, n, step):
        cb = codes[r0:r0 + step]
        rows = cb.shape[0]
        if codes.dtype == torch.int8:
            dots = int8_dot(a, cb).to(torch.float32)
        else:
            b = cb.to(torch.bfloat16) if round_bf16 else cb
            dots = a @ b.to(torch.float32).t()
        val = dots * rowmul[r0:r0 + rows]
        val = val + rowadd[r0:r0 + rows]
        keys = (val.view(torch.int32).view(qp, rows // chunk, nsl, _LANES)
                & -nsl) | slices
        c0 = r0 // chunk * _LANES
        out[:, c0:c0 + rows // chunk * _LANES] = keys.amax(dim=2).reshape(qp, -1)
    return out


def binmax_scan(queries, codes, rowmul, rowadd, *, chunk: int,
                round_bf16: bool) -> torch.Tensor:
    """K1: packed per-bin max keys, ``[qp, N // chunk * 128]`` int32.

    Replaces ``coltt_tpu/ops/scan_pallas.py::_kernel`` (launched by
    ``_binmax_scan``). Column ``c`` is chunk ``c // 128``, lane ``c % 128``;
    the winning slice index is in the key's low bits. ``queries`` are int8
    for int8 codes, else f32.

    On a CUDA tensor this launches one of K1's loops (:func:`k1_plan`) or
    raises; on a CPU tensor it runs :func:`binmax_scan_ref`.
    ``binmax_scan.launches`` counts kernel launches, and
    ``binmax_scan.launches_by`` counts them by ``(code dtype, loop)``.

    What bounds it on the card, at N=1M, D=768, Q=2048: the product, 2*Q*N*D
    operations (3.3e12): 1.67 ms on the int8 tensor cores, 3.34 ms on the
    bf16 ones, 49.2 ms on the f32 CUDA cores; at Q=8 the codes' bytes. The
    loops, each reading the codes about once (query tiles are the grid's
    fastest axis, so the blocks sharing a chunk hit L2) and never writing
    the [Q, N] scores:

    - int8 codes: wgmma s8 x s8 -> s32 fed by TMA (``csrc/binmax_scan.cu``),
      a query tile of :func:`int8_query_tile` queries;
    - ``round_bf16`` (f8, bf16 and f32 codes): wgmma bf16 x bf16 -> f32
      fed by TMA (``csrc/binmax_scan_float.cu``) on the queries rounded to
      bf16 on the device (:func:`kernel_queries`), a tile of
      :func:`bf16_query_tile`;
    - otherwise exact f32 operands on CUDA cores, register-blocked, a tile
      of :func:`exact_query_tile`.
    """
    if codes.device.type == "cpu":
        return binmax_scan_ref(queries, codes, rowmul, rowadd, chunk=chunk,
                               round_bf16=round_bf16)
    if codes.device.type != "cuda":
        raise ValueError(f"binmax_scan: unsupported device {codes.device}")
    tensors = (queries, codes, rowmul, rowadd)
    if any(t.device != codes.device for t in tensors):
        raise ValueError("binmax_scan: tensors on different devices")
    loop = k1_loop(codes.dtype, round_bf16)
    want_q = torch.int8 if loop == LOOP_INT8 else torch.float32
    if queries.dtype != want_q:
        raise TypeError(
            f"binmax_scan: {codes.dtype} codes need {want_q} queries, "
            f"got {queries.dtype}")
    if rowmul.dtype != torch.float32 or rowadd.dtype != torch.float32:
        raise TypeError("binmax_scan: rowmul / rowadd must be float32")
    qp, d = queries.shape
    n = codes.shape[0]
    if (codes.dim() != 2 or codes.shape[1] != d or rowmul.shape != (n,)
            or rowadd.shape != (n,)):
        raise ValueError(
            f"binmax_scan: shapes queries {tuple(queries.shape)}, codes "
            f"{tuple(codes.shape)}, rowmul {tuple(rowmul.shape)}, rowadd "
            f"{tuple(rowadd.shape)}")
    if chunk not in (_CHUNK, 2 * _CHUNK) or n % chunk or d % 128 or qp == 0:
        raise ValueError(
            f"binmax_scan: needs D % 128 == 0 and N % chunk == 0 with chunk "
            f"in (2048, 4096); got N={n}, D={d}, chunk={chunk}, Q={qp}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("binmax_scan: tensors must be contiguous")
    if queries.data_ptr() % 16 or codes.data_ptr() % 16:
        raise ValueError("binmax_scan: queries / codes must be 16-byte aligned")

    libs = load_kernels()
    _, qtile, stream_q = k1_plan(codes.dtype, round_bf16, qp, d)
    kq = kernel_queries(queries, codes.dtype, round_bf16)
    out = torch.empty((qp, n // chunk * _LANES), dtype=torch.int32,
                      device=codes.device)
    nsl = chunk // _LANES
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        head = (kq.data_ptr(), codes.data_ptr(), rowmul.data_ptr(),
                rowadd.data_ptr(), out.data_ptr(), qp, n, d, nsl, qtile)
        code = _CODE_DTYPES[codes.dtype]
        if loop == LOOP_INT8:
            lib = libs["int8"].load()
            err = lib.coltt_binmax_scan_s8(*head, stream)
        elif loop == LOOP_BF16:
            lib = libs["float"].load()
            err = lib.coltt_binmax_scan_bf16(code, *head, int(stream_q), stream)
        else:
            lib = libs["float"].load()
            err = lib.coltt_binmax_scan_f32(code, *head, stream)
    if err != 0:
        raise RuntimeError(
            f"binmax_scan launch failed ({loop}, {codes.dtype}): "
            f"{lib.coltt_error_string(err).decode()}")
    with _LAUNCHES_MU:
        binmax_scan.launches += 1
        key = (str(codes.dtype).removeprefix("torch."), loop)
        binmax_scan.launches_by[key] = binmax_scan.launches_by.get(key, 0) + 1
    return out


binmax_scan.launches = 0
binmax_scan.launches_by = {}


def reset_launch_counts() -> None:
    """Set every kernel launch count of this module to 0."""
    with _LAUNCHES_MU:
        binmax_scan.launches = 0
        binmax_scan.launches_by = {}
        binmax_scan_i8.launches = 0


def _slot_plan(nb: int):
    """``(members S, width)`` for the slot2 selection over ``nb`` bins:
    ``width`` divides ``nb``; a lane-aligned width (a multiple of 128) is
    preferred, then the largest S <= 48 (the two-survivor loss grows
    ~(r*S/nb)^2/2 at shortlist rank r). None when no split exists."""
    aligned = [s for s in range(8, 49) if nb % s == 0 and (nb // s) % 128 == 0]
    if aligned:
        s = max(aligned)
        return s, nb // s
    loose = [s for s in range(8, 49) if nb % s == 0]
    if loose:
        s = max(loose)
        return s, nb // s
    return None


def _topk_keys(keys, kk: int, float_view: bool):
    """Exact top-k of packed int32 keys: ``(sel int32, pos int64)``.
    ``float_view`` ranks them as their f32 bit patterns (K1's keys, whose
    tombstones are negative floats), else as ints (K2's non-negative keys,
    which order the same either way); no arithmetic touches a view."""
    if float_view:
        fsel, pos = torch.topk(keys.view(torch.float32), kk, dim=1, sorted=True)
        return fsel.view(torch.int32), pos
    return torch.topk(keys, kk, dim=1, sorted=True)


def _slot2_select(keys, kk: int, low_bits: int, float_view: bool = True):
    """Two-survivors-per-strided-slot selection over packed int32 keys
    (the reference's ``style="mask"``).

    Slot ``c`` holds the S strided columns ``{c, c+width, ...}`` of the
    ``[Q, nb]`` keys and keeps its best two members, so a bin is lost only
    when two better bins share its slot. The member index replaces the
    ``mbits`` key bits just above the ``low_bits`` already in use, which
    makes every key of a slot distinct: ``m1`` is the slot's max, ``m2``
    the max with ``m1`` masked out. One exact top-k over the ``[Q, 2*width]``
    survivors finishes. Returns ``(sel, pos, drop_bits)``: the selected
    keys, their original bin columns, and how many low key bits are now
    index payload. Falls back to an exact top-k over all bins when there
    is no plan or ``kk`` exceeds the survivors.
    """
    qp, nb = keys.shape
    plan = _slot_plan(nb)
    if plan is None or 2 * (nb // plan[0]) < kk:
        sel, pos = _topk_keys(keys, kk, float_view)
        return sel, pos, low_bits
    s_members, width = plan
    mbits = (s_members - 1).bit_length()
    clear = ~(((1 << mbits) - 1) << low_bits)
    imin = torch.iinfo(torch.int32).min
    km = keys.reshape(qp, s_members, width)
    tag = (torch.arange(s_members, dtype=torch.int32, device=keys.device)
           << low_bits).view(1, s_members, 1)
    tagged = (km & clear) | tag
    m1 = tagged.amax(dim=1)
    m2 = torch.where(tagged == m1.unsqueeze(1), imin, tagged).amax(dim=1)
    cand = torch.cat([m1, m2], dim=1)                      # [qp, 2*width]
    sel, cpos = _topk_keys(cand, kk, float_view)
    member = ((sel >> low_bits) & ((1 << mbits) - 1)).to(cpos.dtype)
    pos = member * width + cpos % width                    # original bin column
    return sel, pos, low_bits + mbits


def scan_inputs(queries, codes, scale, sqnorm, valid, *, metric):
    """The operands K1 gets from the store's state and a query batch.

    Nothing here waits for the device (no host-to-device copy), so
    batches queue back to back. Returns a dict: ``queries`` (the padded
    kernel queries: int8 for int8
    codes, else f32), ``rowmul`` / ``rowadd`` ([N] f32 per-row factors
    with the tombstone penalty and the bias folded in), ``bias``, and the
    per-query affine ``qmul`` / ``qadd`` that maps un-biased winners back
    to negated distances. Mirrors the JAX wrapper's arithmetic step by step.
    """
    metric = Metric.parse(metric)
    dev = codes.device
    f32 = torch.float32
    queries = torch.as_tensor(queries, dtype=f32, device=dev)
    q, d = queries.shape
    n = codes.shape[0]
    int8 = codes.dtype == torch.int8
    qp, _ = _pick_qblock(q, 32 if int8 else 8)
    if qp != q:
        queries = torch.cat([queries, queries.new_zeros((qp - q, d))])

    scale_row = (torch.ones(n, dtype=f32, device=dev) if scale is None
                 else scale.reshape(n))
    penalty = (torch.where(valid, torch.zeros((), dtype=f32, device=dev),
                           torch.full((), _PENALTY, dtype=f32, device=dev))
               if valid is not None else torch.zeros(n, dtype=f32, device=dev))

    qsq = (queries * queries).sum(dim=1, keepdim=True)
    if int8:
        if metric == Metric.COSINE:
            qkern, qscale = quantize_queries_i8(queries)
        else:
            # euclidean: the query scale multiplies only the dot term, not
            # -|v|^2, so it cannot leave the kernel per query — one scalar
            gmax = queries.abs().amax()
            gscale = torch.where(gmax > 0, gmax / 127.0, torch.ones_like(gmax))
            qkern = torch.round(queries / gscale).clamp(-127, 127).to(torch.int8)
    else:
        qkern = queries

    if metric == Metric.COSINE:
        rowmul = scale_row * torch.rsqrt(sqnorm.clamp(min=1e-30))
        rowadd = penalty
        qn = torch.sqrt(qsq).clamp(min=1e-30)
        qmul = (qscale / qn) if int8 else (1.0 / qn)
        qadd = torch.full((), -1.0, dtype=f32, device=dev)
        # |val| <= ||q_kern|| by Cauchy-Schwarz: static for int8 queries
        if int8:
            bound = torch.full((), 127.0 * math.sqrt(d), dtype=f32, device=dev)
        else:
            bound = torch.sqrt(qsq.amax())
    elif metric == Metric.EUCLIDEAN:
        rowmul = 2.0 * scale_row * (gscale if int8 else 1.0)
        rowadd = penalty - sqnorm
        qmul = torch.ones((qp, 1), dtype=f32, device=dev)
        qadd = -qsq
        maxsq = sqnorm.amax()
        qn_bound = (torch.full((), 127.0 * math.sqrt(d), dtype=f32, device=dev)
                    * gscale if int8 else torch.sqrt(qsq.amax()))
        bound = 2.0 * qn_bound * torch.sqrt(maxsq) + maxsq
    else:
        raise ValueError(f"fused scan supports cosine and euclidean, not {metric.name}")
    # 2x margin covers bf16 operand rounding and the f32 rounding of val;
    # the clamp keeps penalty + bias finite
    bias = (2.0 * bound).clamp(max=1e36)
    return {
        "queries": qkern.contiguous(),
        "rowmul": rowmul.contiguous(),
        "rowadd": (rowadd + bias).contiguous(),
        "bias": bias,
        "qmul": qmul,
        "qadd": qadd,
        "q": q,
    }


def fused_scan_keys(queries, codes, scale, sqnorm, valid, *,
                    metric: Metric = Metric.COSINE,
                    compute_dtype=torch.bfloat16) -> dict:
    """The scan step of :func:`fused_scan_neg_topk`: K1 over the rows.

    Returns :func:`scan_inputs`'s dict with ``keys`` (K1's ``[Qp, nb]``
    int32 bin survivors), ``chunk`` and ``sbits`` (the slice bits in the
    keys' low mantissa) added; :func:`select_bins` selects on the keys.
    """
    metric = Metric.parse(metric)
    if codes.dtype != torch.int8 and compute_dtype not in (torch.bfloat16,
                                                           torch.float32):
        raise ValueError(f"fused scan computes in bf16 or f32, not {compute_dtype}")
    chunk = chunk_for(codes.shape[0])
    inp = scan_inputs(queries, codes, scale, sqnorm, valid, metric=metric)
    inp["keys"] = binmax_scan(
        inp["queries"], codes, inp["rowmul"], inp["rowadd"], chunk=chunk,
        round_bf16=compute_dtype == torch.bfloat16,
    )
    inp["chunk"] = chunk
    inp["sbits"] = (chunk // _LANES).bit_length() - 1
    return inp


def fused_scan_neg_topk(
    queries,
    codes,
    scale,
    sqnorm,
    valid,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=torch.bfloat16,
    final: str = "auto",
):
    """Fused top-k: ``(negdist [Q,k], ids [Q,k])``.

    Drop-in for :func:`coltt_tpu_torch.ops.topk.scan_neg_topk` where
    :func:`supports` holds. Float codes are multiplied as ``compute_dtype``
    operands (bf16, or f32 for unquantized stores); int8 codes take the
    s8 x s8 product with queries quantized on the fly. ``final``, one of
    :data:`FINALS`, picks the selection over the bin survivors (module
    docstring); any other name raises.
    """
    _check_final(final)
    inp = fused_scan_keys(queries, codes, scale, sqnorm, valid, metric=metric,
                          compute_dtype=compute_dtype)
    keys, chunk = inp["keys"], inp["chunk"]
    nsl = chunk // _LANES
    sel, pos, drop = select_bins(keys, min(k, keys.shape[1]), final, inp["sbits"])
    ids = (pos // _LANES) * chunk + (sel & (nsl - 1)).to(pos.dtype) * _LANES \
        + pos % _LANES
    best = (sel & -(1 << drop)).view(torch.float32)
    # un-bias, then the per-query affine back to negated distances
    negd = (best - inp["bias"]) * inp["qmul"] + inp["qadd"]
    negd = torch.where(best > _INVALID_CUT, negd,
                       torch.full_like(negd, -float("inf")))
    q = inp["q"]
    return negd[:q], ids[:q].to(torch.int32)


def select_bins(keys, kk: int, final: str, low_bits: int):
    """The selection stage of :func:`fused_scan_neg_topk`: the best ``kk``
    of K1's ``[Q, nb]`` keys under ``final`` (module docstring), as
    ``(sel, pos, drop_bits)``: the selected keys, their bin columns, and
    how many low key bits are index payload (``low_bits``, the slice
    bits, unless slot2's member tag added its own). Selects on the f32
    view of the keys: valid keys are bit patterns of positive normal
    floats (order kept, all 32 bits), tombstones ~-3e38 normals that sort
    last."""
    if final in _SLOT2:
        return _slot2_select(keys, kk, low_bits)
    return (*_topk_keys(keys, kk, float_view=True), low_bits)


def _check_final(final: str) -> None:
    if final not in FINALS:
        raise ValueError(f"final={final!r}: not one of {', '.join(FINALS)}")


def fused_scan_topk(
    queries, codes, scale, sqnorm, valid, *, k,
    metric: Metric = Metric.COSINE, compute_dtype=torch.bfloat16,
    final: str = "auto",
):
    """0-100-scored variant (scan_topk parity)."""
    metric = Metric.parse(metric)
    negd, idx = fused_scan_neg_topk(
        queries, codes, scale, sqnorm, valid, k=k, metric=metric,
        compute_dtype=compute_dtype, final=final,
    )
    return scores_from_negd(negd, metric), idx


# ---------------------------------------------------------------------------
# unit-norm int8 cosine path: K2, an all-integer epilogue
# ---------------------------------------------------------------------------


def unit_i8_supports(n: int, dim: int, metric) -> bool:
    """Shape / metric rules of the integer path. ``dim <= 2048`` bounds the
    packed key: |dot| <= 127*127*dim, and ``dot << 5`` must stay under
    2^30 so that neither the dead sentinel nor the +2^30 shift overflows
    int32 (the shifted maximum, 2^30 + 127^2 * 2048 * 32 + 31, also stays
    below the f32 NaN bit patterns the reference selects on)."""
    return (
        Metric.parse(metric) == Metric.COSINE
        and dim % 128 == 0
        and dim <= _UNIT_MAX_DIM
        and n % _CHUNK == 0
    )


def unit_i8_bin_live(valid: torch.Tensor, chunk: int) -> torch.Tensor:
    """``[nbins]`` bool: bins holding at least one valid row, in the
    kernels' bin order (chunk-major, lane-minor). ``valid``'s length must
    divide by ``chunk``."""
    n = valid.shape[0]
    nsl = chunk // _LANES
    return valid.reshape(n // chunk, nsl, _LANES).any(dim=1).reshape(-1)


def binmax_scan_i8_ref(queries, codes, *, chunk: int) -> torch.Tensor:
    """Plain PyTorch version of K2: ``[qp, N // chunk * 128]`` int32 keys.

    The exact int8 product (``torch._int_mm``), then ``(dot << sh) | s``
    and an integer max over the slices, blocked over row chunks so that it
    never holds ``[Q, N]`` at once. ``bitwise_left_shift`` wraps a
    negative int32 as two's complement, as ``jnp.left_shift`` does.
    """
    qp = queries.shape[0]
    n = codes.shape[0]
    nsl = chunk // _LANES
    sh = nsl.bit_length() - 1
    out = torch.empty((qp, n // chunk * _LANES), dtype=torch.int32,
                      device=codes.device)
    slices = torch.arange(nsl, dtype=torch.int32, device=codes.device).view(
        1, 1, nsl, 1)
    step = max(1, _REF_STEP_BYTES // (qp * chunk * 4)) * chunk
    for r0 in range(0, n, step):
        dots = int8_dot(queries, codes[r0:r0 + step])
        rows = dots.shape[1]
        keys = torch.bitwise_left_shift(
            dots.view(qp, rows // chunk, nsl, _LANES), sh) | slices
        c0 = r0 // chunk * _LANES
        out[:, c0:c0 + rows // chunk * _LANES] = keys.amax(dim=2).reshape(qp, -1)
    return out


def binmax_scan_i8(queries, codes, *, chunk: int) -> torch.Tensor:
    """K2: packed per-bin max keys ``(dot << log2(nsl)) | slice``,
    ``[qp, N // chunk * 128]`` int32.

    Replaces ``coltt_tpu/ops/scan_pallas.py::_int_kernel`` (launched by
    ``_binmax_scan_i8``). Column ``c`` is chunk ``c // 128``, lane
    ``c % 128``, as in K1. On a CUDA tensor this launches
    ``csrc/binmax_scan.cu`` (``coltt_binmax_scan_i8``) or raises; on a CPU
    tensor it runs :func:`binmax_scan_i8_ref`. ``binmax_scan_i8.launches``
    counts kernel launches.

    What bounds it on the card: the s8 x s8 product, 2*Q*N*D operations
    (3.2e12 at Q=2048, N=1,003,520, D=768: 1.60 ms at the int8
    tensor-core peak); at Q=8 the codes' bytes. It runs K1's int8
    tensor-core loop; the epilogue is a shift and an or instead of K1's
    float multiply-add and bit pack.
    """
    if codes.device.type == "cpu":
        return binmax_scan_i8_ref(queries, codes, chunk=chunk)
    if codes.device.type != "cuda":
        raise ValueError(f"binmax_scan_i8: unsupported device {codes.device}")
    if queries.device != codes.device:
        raise ValueError("binmax_scan_i8: tensors on different devices")
    if queries.dtype != torch.int8 or codes.dtype != torch.int8:
        raise TypeError(
            f"binmax_scan_i8: needs int8 queries and codes, got "
            f"{queries.dtype} and {codes.dtype}")
    qp, d = queries.shape
    n = codes.shape[0]
    if codes.dim() != 2 or codes.shape[1] != d:
        raise ValueError(
            f"binmax_scan_i8: shapes queries {tuple(queries.shape)}, codes "
            f"{tuple(codes.shape)}")
    if (chunk not in (_CHUNK, 2 * _CHUNK) or n % chunk or d % 128
            or d > _UNIT_MAX_DIM or qp == 0):
        raise ValueError(
            f"binmax_scan_i8: needs D % 128 == 0, D <= {_UNIT_MAX_DIM} and "
            f"N % chunk == 0 with chunk in (2048, 4096); got N={n}, D={d}, "
            f"chunk={chunk}, Q={qp}")
    if not (queries.is_contiguous() and codes.is_contiguous()):
        raise ValueError("binmax_scan_i8: tensors must be contiguous")
    if queries.data_ptr() % 16 or codes.data_ptr() % 16:
        raise ValueError("binmax_scan_i8: queries / codes must be 16-byte aligned")

    lib = load_kernels()["int8"].load()
    out = torch.empty((qp, n // chunk * _LANES), dtype=torch.int32,
                      device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.coltt_binmax_scan_i8(
            queries.data_ptr(), codes.data_ptr(), out.data_ptr(), qp, n, d,
            chunk // _LANES, int8_query_tile(qp), stream)
    if err != 0:
        raise RuntimeError(
            f"binmax_scan_i8 launch failed: "
            f"{lib.coltt_error_string(err).decode()}")
    with _LAUNCHES_MU:
        binmax_scan_i8.launches += 1
    return out


binmax_scan_i8.launches = 0


def fused_unit_i8_neg_topk(queries, codes, gscale, bin_live, *, k,
                           final: str = "auto"):
    """Cosine shortlist over unit-norm, global-scale int8 rows.

    Returns ``(negd [Q, k], ids [Q, k])``: the int8-precision negated
    cosine distance (comparable across stores, since ``gscale`` is global
    and the query factor is per query) and the row ids. ``final``:
    "auto" is slot2 above 8192 bins, else exact; "approx" is exact, as in
    :func:`fused_scan_neg_topk`; every other name of :data:`FINALS` is the
    exact top-k, as in the reference. Callers rerank the shortlist, which
    also drops a tombstoned or padding row that won a live bin.
    """
    _check_final(final)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=codes.device)
    q, d = queries.shape
    n = codes.shape[0]
    if not unit_i8_supports(n, d, Metric.COSINE):
        # a wider dim would overflow the packed key into wrong ids / scores
        raise ValueError(
            f"fused_unit_i8_neg_topk unsupported for n={n}, dim={d}: needs "
            f"dim % 128 == 0, dim <= {_UNIT_MAX_DIM}, n % {_CHUNK} == 0")
    chunk = chunk_for(n)
    nsl = chunk // _LANES
    sh = nsl.bit_length() - 1

    qp, _ = _pick_qblock(q, 32)
    qf = torch.cat([queries, queries.new_zeros((qp - q, d))]) if qp != q \
        else queries
    qi, qscale = quantize_queries_i8(qf)

    packed = binmax_scan_i8(qi.contiguous(), codes, chunk=chunk)
    packed = torch.where(bin_live.view(1, -1), packed, _DEAD)
    # +2^30 keeps the low slice bits, makes every real key positive (the
    # least is ~-1.06e9 > -2^30) and turns _DEAD into exactly 0
    shifted = packed + (1 << 30)
    nb = packed.shape[1]
    kk = min(k, nb)
    if final == "auto":
        # slot2 at serving sizes, the reference's rule from its TPU frontier
        # (an exact top-k over [Q, ~31k] bins cost about as much as the
        # scan there); K2's keys have no H100 frontier yet
        final = "slot2" if (nb > 8192 and _slot_plan(nb)) else "exact"
    if final == "slot2" and kk < nb and _slot_plan(nb):
        ssel, pos, _ = _slot2_select(shifted, kk, sh, float_view=False)
        # the member tag overwrote the dot's low bits: a <= 2^6 nudge of
        # a ~1e7-scale dot; the slice bits are intact
        sel = ssel - (1 << 30)
    else:
        _, pos = _topk_keys(shifted, kk, float_view=False)
        sel = torch.gather(packed, 1, pos)
    ids = (pos // _LANES) * chunk + (sel & (nsl - 1)).to(pos.dtype) * _LANES \
        + pos % _LANES

    qn = torch.sqrt((qf * qf).sum(dim=1, keepdim=True)).clamp(min=1e-30)
    dots = (sel >> sh).to(torch.float32)
    negd = dots * (gscale * qscale / qn) - 1.0  # cos - 1 = -dist
    # dead bins sit at ~-2^30 (slot2's tag can nudge _DEAD), real keys
    # above -2^29
    negd = torch.where(sel < -(1 << 29), -float("inf"), negd)
    return negd[:q], ids[:q].to(torch.int32)

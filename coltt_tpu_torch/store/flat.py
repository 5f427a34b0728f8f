"""FLAT quantized vector store with slot-based mutation, on torch tensors.

Port of ``coltt_tpu/store/flat.py``. Vectors live in a dense
``[capacity, width]`` tensor on the store's device, with a per-row fp32
scale, the squared norms of the dequantized rows, and a validity
(tombstone) mask. Mutation is slot-based and staged:

- upsert resolves the primary key to an existing slot (overwrite) or pops
  a free slot / appends; rows are staged host-side and applied at the next
  ``sync`` in one batched scatter, encoded on the device;
- delete tombstones the slot (valid=False) and returns it to the free list;
- capacity grows by doubling from 8192 rows, so the fused kernel's shape
  rules always hold.

Modes:

- dense (none / f16 / bf16 / f8 / i8): the blocked scan
  (:mod:`coltt_tpu_torch.ops.topk`) or, with ``fused=True`` where
  :func:`~coltt_tpu_torch.ops.fused_scan.supports` holds, the fused kernel
  K1;
- BQ (:mod:`~coltt_tpu_torch.ops.bq`): packed sign words ``[cap, W]``
  int32, a Hamming shortlist of ``k * bq_oversample`` rows, then by
  default a rerank against a bf16 (or f16 / f8) copy of the rows, which is
  authoritative extra state and goes into the snapshot; cosine only;
- PQ (:mod:`~coltt_tpu_torch.ops.pq`): the authoritative ``[cap, M]``
  uint8 codes (``[cap, 2+M]`` in residual mode), the codebook trained on
  the first synced batch. With ``pq_cache`` (default) the codes are
  decompressed once per mutation into an f8 scan cache of the
  reconstruction, which every dense scan (K1 included) serves, and
  ``oversample > 1`` reranks a shortlist against the exact f32
  reconstruction; ``pq_host_codes`` keeps the code table on the host and
  gathers the shortlist's rows there. ``pq_cache=False`` scans the codes
  by ADC (low memory). With OPQ, queries are rotated before any scan of
  the cache.

Filtered search gathers the candidate rows when there are few
(``capacity // 6``) and scans them with the plain scan; otherwise it masks
a full scan (through K1 under ``fused``). ``bench_filtered.py`` times the
three regimes on the card.

Over a :class:`~coltt_tpu_torch.parallel.mesh.Mesh` (``device=mesh``, the
reference's ``mesh``) every row tensor is
:class:`~coltt_tpu_torch.parallel.mesh.ShardedRows`: slot ``s`` lives on
shard ``s // (capacity / shards)``. Capacity is a multiple of ``shards x
8192`` rows, so every shard's rows suit K1. ``sync`` routes each staged
row to its shard (out of place per touched shard while a search holds
the store), growth re-cuts the blocks, and every search is the
shard-local scan and merge of ``parallel/dist_search.py``: a filtered one
always masks the scan (gathering would pull rows across shards), and a
host-codes PQ store keeps its exact rerank, shard by shard (the
reference's ``flat.py:1090`` serves such a store without it; the port
keeps the one-device results). A one-device mesh is the one-device store.
"""

from __future__ import annotations

import copy
import io
import threading
import time
from typing import Dict, List, Optional, Tuple

import msgpack
import numpy as np
import torch

from coltt_tpu_torch.ops.bq import (
    bq_decode,
    bq_encode,
    bq_words,
)
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.pq import (
    PQCodebook,
    _reconstruct,
    default_subspaces,
    pq_encode,
    pq_reconstruct,
    pq_scan_topk,
    pq_sqnorm,
    train_pq,
)
from coltt_tpu_torch.ops.quant import Quantization, dequantize, quantize, storage_dtype
from coltt_tpu_torch.ops.topk import (
    fetch_scores_ids,
    fit_rows,
    scan_topk,
    scores_from_negd,
)
from coltt_tpu_torch.parallel.dist_search import (
    bq_shortlist_topk,
    sharded_bq_topk,
    sharded_pq_topk,
    sharded_scan_topk,
)
from coltt_tpu_torch.parallel.mesh import ShardedRows, replicate, split
from coltt_tpu_torch.utils import trace

_CAPACITY_QUANTUM = 8192
# filtered searches with fewer than capacity // _GATHER_FRACTION candidates
# gather the rows, so a search copies at most a sixth of the store
_GATHER_FRACTION = 6
# a PQ-cache collection loads with its code table on the host when the
# table passes this size (the reference's rule, set for a 16 GB chip;
# results are the same either way)
PQ_HOST_CODES_BYTES = 2 << 30

_SNAPSHOT_MAGIC = b"CTTFLAT1"

# numpy has no bf16 / f8 dtype: snapshot bytes go through an integer view
# of the same width
_INT_VIEW = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _round_capacity(n: int, quantum: int = _CAPACITY_QUANTUM) -> int:
    """The least ``quantum * 2**j`` >= ``n`` (a mesh's quantum is ``shards
    x 8192``)."""
    cap = quantum
    while cap < n:
        cap *= 2
    return cap


def state_row(t, slot: int) -> torch.Tensor:
    """Row ``slot`` of a state tensor or ShardedRows."""
    return t.row(slot) if isinstance(t, ShardedRows) else t[slot]


def scatter_rows(t, slots_np: np.ndarray, slots, src, *, inplace: bool):
    """``t`` with rows ``src`` written at ``slots`` (sorted; numpy and a
    device tensor of the same), in place or into new tensors."""
    if isinstance(t, ShardedRows):
        return t.scatter(slots_np, src, inplace=inplace)
    if inplace:
        return t.index_put_((slots,), src)
    return t.index_put((slots,), src)


def grow_rows(t, n: int, fill=0.0):
    """``t`` padded to ``n`` rows of ``fill`` (new tensors, so live search
    snapshots keep the old ones)."""
    if isinstance(t, ShardedRows):
        return t.regrow(n, fill)
    return torch.cat([t, t.new_full((n - t.shape[0], *t.shape[1:]), fill)])


def tensor_to_bytes(t: torch.Tensor) -> bytes:
    """Raw little-endian bytes of a tensor, any dtype (bf16 / f8 included)."""
    t = t.detach().contiguous().cpu()
    if t.dtype != torch.bool:
        t = t.view(_INT_VIEW[t.element_size()])
    return t.numpy().tobytes()


def tensor_from_bytes(raw, dtype: torch.dtype, shape) -> torch.Tensor:
    """Inverse of :func:`tensor_to_bytes` (a CPU tensor owning its memory)."""
    if dtype == torch.bool:
        return torch.frombuffer(bytearray(raw), dtype=torch.bool).reshape(shape)
    ints = torch.frombuffer(bytearray(raw), dtype=_INT_VIEW[dtype.itemsize])
    return ints.view(dtype).reshape(shape)


_SAVE_ROWS = 131_072  # rows fetched per device->host chunk on save


def write_rows(f, t) -> None:
    """Stream a tensor, a ShardedRows (shard by shard) or a host array to
    ``f`` in row chunks, so the host never holds more than one chunk of
    it."""
    if isinstance(t, ShardedRows):
        for block in t.host_blocks():
            write_rows(f, block)
        return
    for i in range(0, t.shape[0], _SAVE_ROWS):
        part = t[i:i + _SAVE_ROWS]
        f.write(np.ascontiguousarray(part).tobytes() if isinstance(part, np.ndarray)
                else tensor_to_bytes(part))


def pq_cache_rows(pqcodes: torch.Tensor, codebook: PQCodebook):
    """The f8 scan cache of PQ code rows: each row reconstructed in f32
    (residual-aware), quantized to f8 with its per-row scale, and the
    squared norm of the dequantized row. Returns ``(codes [N, D] f8,
    scale [N, 1] f32, sqnorm [N] f32)``, blocked over rows by free
    memory."""
    n = pqcodes.shape[0]
    d = codebook.dim
    dev = pqcodes.device
    codes = torch.empty((n, d), dtype=torch.float8_e4m3fn, device=dev)
    scale = torch.empty((n, 1), dtype=torch.float32, device=dev)
    sqnorm = torch.empty(n, dtype=torch.float32, device=dev)
    step = fit_rows(n, d * 16 + pqcodes.shape[1] * 8, dev)
    for s in range(0, n, step):
        rec = _reconstruct(pqcodes[s:s + step], codebook.centroids,
                           torch.float32, coarse=codebook.coarse)
        c8, s8 = quantize(rec, Quantization.F8)
        deq = dequantize(c8, s8)
        codes[s:s + step], scale[s:s + step] = c8, s8
        sqnorm[s:s + step] = (deq * deq).sum(dim=1)
    return codes, scale, sqnorm


def _fetch(scores, slots):
    """``fetch_scores_ids`` under the ``store.fetch`` span: the copy of a
    top-k to the host, where the host waits for the device."""
    with trace.span("store.fetch"):
        return fetch_scores_ids(scores, slots)


def _locked(fn):
    """Serialize a store method under the store's lock ``_mu`` (FlatStore
    and MultiVectorStore; search releases it for the scan itself, see
    :meth:`FlatStore.search`). RLock: search -> sync re-enters."""
    def wrapper(self, *a, **kw):
        with self._mu:
            return fn(self, *a, **kw)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


class FlatStore:
    """Quantized FLAT store over dense slots on one torch device, or
    row-sharded over a :class:`Mesh` passed as ``device``."""

    def __init__(
        self,
        dim: int,
        *,
        metric: Metric = Metric.COSINE,
        quantization: Quantization = Quantization.NONE,
        compute_dtype=None,
        device="cuda",
        pq_subspaces: Optional[int] = None,
        pq_centroids: int = 256,
        pq_train_iters: int = 15,
        pq_cache: bool = True,
        pq_host_codes: bool = False,
        pq_opq_iters: int = 0,
        pq_coarse: int = 0,
        bq_rerank: bool = True,
        bq_oversample: int = 64,
        bq_rerank_dtype=Quantization.BF16,
    ):
        self._mu = threading.RLock()
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        self.quantization = Quantization.parse(quantization)
        # a mesh of more than one device shards the store
        self.mesh, self.device, self._where = split(device, single_as_device=True)
        # capacity quantum: every shard's rows a multiple of 8192
        self._quantum = _CAPACITY_QUANTUM * (self.mesh.shards if self.mesh else 1)
        self._cb_reps = None
        self.is_pq = self.quantization == Quantization.PQ
        self.is_bq = self.quantization == Quantization.BQ
        self.pq_cache = bool(pq_cache) and self.is_pq
        self.pq_host = bool(pq_host_codes) and self.pq_cache
        self.bq_rerank = bool(bq_rerank) and self.is_bq
        self.bq_oversample = int(bq_oversample)
        self.bq_rr_quant = Quantization.parse(bq_rerank_dtype)
        if self.is_bq and self.bq_rr_quant not in (
            Quantization.BF16, Quantization.F16, Quantization.F8
        ):
            raise ValueError("bq_rerank_dtype must be bf16/f16/f8")
        if self.is_bq and self.metric != Metric.COSINE:
            raise ValueError("BQ quantization is cosine-only (sign bits carry no magnitude)")
        self.codebook: Optional[PQCodebook] = None
        if self.is_pq:
            self._qdtype = torch.uint8
            self.pq_m = int(pq_subspaces or default_subspaces(self.dim))
            if self.dim % self.pq_m != 0:
                raise ValueError(
                    f"dim {self.dim} not divisible by pq_subspaces={self.pq_m}")
            self.pq_centroids = int(pq_centroids)
            self.pq_train_iters = int(pq_train_iters)
            self.pq_opq_iters = int(pq_opq_iters)
            self.pq_coarse = int(pq_coarse)
            # residual codes carry the uint16 coarse id as a 2-byte prefix
            self.pq_width = self.pq_m + (2 if self.pq_coarse else 0)
            self._row_width = self.pq_width
        elif self.is_bq:
            self._qdtype = torch.int32  # the reference's uint32 bits
            self._row_width = bq_words(self.dim)
        else:
            self._qdtype = storage_dtype(self.quantization)
            self._row_width = self.dim
        # unquantized stores scan in full f32; quantized stores multiply
        # bf16 operands (their codes carry less than bf16 anyway)
        if compute_dtype is None:
            compute_dtype = (
                torch.float32 if self.quantization == Quantization.NONE
                else torch.bfloat16
            )
        self.compute_dtype = compute_dtype

        self._alloc(self._quantum)

        self.pk_to_slot: Dict[str, int] = {}
        self.slot_to_pk: Dict[int, str] = {}
        # slot_to_pk as a column indexed by slot ("" at a free slot): the
        # keys of a search's hits in one gather (pks_at)
        self.pk_col = np.full(self.capacity, "", object)
        self._free: List[int] = []
        self._next_slot = 0

        # staged mutations: slot -> (f32 row | None for delete)
        self._pending: Dict[int, Optional[np.ndarray]] = {}
        # live unlocked-search snapshots (see search / sync)
        self._readers = 0

    # -- device state ------------------------------------------------------
    @property
    def _scan_shape(self):
        """(width, dtype) of ``self.codes``, the tensor dense scans read."""
        if self.pq_cache:
            return self.dim, torch.float8_e4m3fn
        return self._row_width, self._qdtype

    def _pq_code_array(self):
        """The authoritative PQ code rows: numpy in host-codes mode, a
        device tensor otherwise."""
        if self.pq_host:
            return self.pqcodes_host
        return self.pqcodes if self.pq_cache else self.codes

    def _zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _ones(self, shape):
        return torch.ones(shape, dtype=torch.float32, device=self.device)

    def _place(self, t: torch.Tensor):
        """A capacity-sized state tensor as the store holds it: itself, or
        cut into the mesh's shards."""
        return t if self.mesh is None else ShardedRows.place(self.mesh, t)

    def _state(self, shape, dtype, fill=0.0):
        """A new capacity-sized state tensor of ``fill``, made on each
        shard's device on a mesh."""
        if self.mesh is None:
            return torch.full(shape, fill, dtype=dtype, device=self.device)
        return ShardedRows.build(self.mesh, shape[0], lambda lo, hi, d: torch.full(
            (hi - lo, *shape[1:]), fill, dtype=dtype, device=d))

    # state tensors and the value of their empty rows
    _FILLS = (("codes", 0), ("pqcodes", 0), ("rr_codes", 0), ("rr_scale", 1.0),
              ("scale", 1.0), ("sqnorm", 0), ("valid", False))

    def _alloc(self, cap: int) -> None:
        width, dtype = self._scan_shape
        self.codes = self._state((cap, width), dtype)
        self.pqcodes = self.pqcodes_host = None
        if self.pq_host:
            self.pqcodes_host = np.zeros((cap, self.pq_width), np.uint8)
        elif self.pq_cache:
            self.pqcodes = self._state((cap, self.pq_width), torch.uint8)
        self.rr_codes = self.rr_scale = None
        if self.bq_rerank:
            self.rr_codes = self._state((cap, self.dim), storage_dtype(self.bq_rr_quant))
            self.rr_scale = self._state((cap, 1), torch.float32, 1.0)
        self.scale = self._state((cap, 1), torch.float32, 1.0)
        self.sqnorm = self._state((cap,), torch.float32)
        self.valid = self._state((cap,), torch.bool, False)
        self.capacity = cap

    def _grow(self, need: int) -> None:
        self._resize(_round_capacity(need, self._quantum))

    def _fit_layout(self) -> None:
        """After the state tensors were set whole on ``self.device`` at
        ``capacity`` rows (a load, a bulk build): pad them to a multiple of
        the store's quantum and cut them into the mesh's shards."""
        if self.capacity % self._quantum:
            self._resize(_round_capacity(self.capacity, self._quantum))
        if self.mesh is not None:
            for name, _ in self._FILLS:
                t = getattr(self, name)
                if torch.is_tensor(t):
                    setattr(self, name, self._place(t))

    def _resize(self, new_cap: int) -> None:
        """Every state tensor padded to ``new_cap`` rows (new tensors, so
        live search snapshots keep the old ones; a mesh's blocks are cut
        anew, the slots unchanged)."""
        for name, fill in self._FILLS:
            t = getattr(self, name)
            if t is not None:
                setattr(self, name, grow_rows(t, new_cap, fill))
        if self.pq_host:
            self.pqcodes_host = np.concatenate([
                self.pqcodes_host,
                np.zeros((new_cap - self.capacity, self.pq_width), np.uint8)])
        col = np.full(new_cap, "", object)
        col[:len(self.pk_col)] = self.pk_col
        self.pk_col = col
        self.capacity = new_cap

    # -- mutation ----------------------------------------------------------
    def _take_slot(self) -> int:
        if self._free:
            return self._free.pop()
        slot = self._next_slot
        self._next_slot += 1
        if self._next_slot > self.capacity:
            self._grow(self._next_slot)
        return slot

    @_locked
    def upsert(self, pk: str, vector: np.ndarray) -> int:
        """Insert or overwrite by primary key (ChangedVertex parity,
        edge/f16_vectorstore.go:67-107)."""
        vec = np.asarray(vector, np.float32).reshape(-1)
        if vec.shape[0] != self.dim:
            raise ValueError(
                f"dimension mismatch: got {vec.shape[0]}, collection dim {self.dim}"
            )
        slot = self.pk_to_slot.get(pk)
        if slot is None:
            slot = self._take_slot()
            self.pk_to_slot[pk] = slot
            self.slot_to_pk[slot] = pk
            self.pk_col[slot] = pk
        self._pending[slot] = vec
        return slot

    @_locked
    def upsert_many(self, pks, vectors) -> List[int]:
        """Bulk upsert: one staging pass, one scatter at next sync."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(
                f"expected [N, {self.dim}] vectors, got {vectors.shape}"
            )
        if len(pks) != vectors.shape[0]:
            raise ValueError("pks/vectors length mismatch")
        slots = []
        for pk, vec in zip(pks, vectors):
            slot = self.pk_to_slot.get(pk)
            if slot is None:
                slot = self._take_slot()
                self.pk_to_slot[pk] = slot
                self.slot_to_pk[slot] = pk
                self.pk_col[slot] = pk
            self._pending[slot] = vec
            slots.append(slot)
        return slots

    def _train(self, rows: torch.Tensor) -> PQCodebook:
        return train_pq(
            rows, m=self.pq_m, n_centroids=self.pq_centroids,
            iters=self.pq_train_iters, opq_iters=self.pq_opq_iters,
            coarse_centroids=self.pq_coarse,
        )

    @_locked
    def bulk_build(self, pks, vectors) -> None:
        """Device-side bulk ingest of an empty store: ``vectors`` (numpy or
        a tensor) are encoded on the device without host staging; a PQ
        store trains its codebook on them first."""
        if len(self.pk_to_slot) or self._pending or self._free:
            raise RuntimeError("bulk_build requires an empty store")
        vectors = torch.as_tensor(vectors, dtype=torch.float32).to(self.device)
        n, d = vectors.shape
        if d != self.dim:
            raise ValueError(f"expected [N, {self.dim}] vectors, got {tuple(vectors.shape)}")
        if len(pks) != n:
            raise ValueError("pks/vectors length mismatch")
        cap = max(_round_capacity(n, self._quantum), self.capacity)
        pad = cap - n

        def padded(t, value=0.0):
            shape = (pad, *t.shape[1:])
            return torch.cat([t, t.new_full(shape, value) if value else t.new_zeros(shape)])

        if self.is_pq:
            if self.codebook is None:
                self.codebook = self._train(vectors)
            u_pq, u_sqnorm = pq_encode(padded(vectors), self.codebook)
            if self.pq_cache:
                if self.pq_host:
                    self.pqcodes_host = u_pq.cpu().numpy()
                else:
                    self.pqcodes = u_pq
                self.codes, self.scale, self.sqnorm = pq_cache_rows(u_pq, self.codebook)
            else:
                self.codes, self.scale, self.sqnorm = u_pq, self._ones((cap, 1)), u_sqnorm
        elif self.is_bq:
            self.codes = padded(bq_encode(vectors))
            if self.bq_rerank:
                rr, rr_s = quantize(vectors, self.bq_rr_quant)
                self.rr_codes = padded(rr)
                self.rr_scale = padded(rr_s, 1.0)
            # scale / sqnorm are unused by the Hamming scan; kept in step
            self.scale = self._ones((cap, 1))
            self.sqnorm = self._zeros((cap,), torch.float32)
        else:
            codes, scale = quantize(vectors, self.quantization)
            deq = dequantize(codes, scale)
            self.codes = padded(codes)
            self.scale = padded(scale, 1.0)
            self.sqnorm = padded((deq * deq).sum(dim=1))
        self.valid = torch.arange(cap, device=self.device) < n
        self.capacity = cap
        self._fit_layout()
        self._next_slot = n
        self.pk_to_slot = dict(zip(pks, range(n)))
        self.slot_to_pk = dict(enumerate(pks))
        self.pk_col = np.full(self.capacity, "", object)
        self.pk_col[:n] = pks

    @_locked
    def delete(self, pk: str) -> Optional[int]:
        """Tombstone + free the slot (RemoveVertex parity,
        edge/f16_vectorstore.go:108-130)."""
        slot = self.pk_to_slot.pop(pk, None)
        if slot is None:
            return None
        self.slot_to_pk.pop(slot, None)
        self.pk_col[slot] = ""
        self._pending[slot] = None
        self._free.append(slot)
        return slot

    @_locked
    def sync(self) -> None:
        """Apply staged mutations in one batched scatter, encoding on the
        device: quantized (and ``sqnorm`` recomputed from the dequantized
        rows), sign-packed (BQ, with its rerank copy), or PQ-encoded and
        decompressed into the f8 cache (the first batch with live rows
        trains the codebook).

        Writes in place when no search snapshot is live; while one is
        (``_readers > 0``), writes out of place so the snapshot's tensors
        never change under its scan. A host-resident PQ code table follows
        the same rule: under a live snapshot the rows go into a copy of the
        table, swapped in by assignment, so a search gathering its
        shortlist's code rows never reads a half-written row."""
        if not self._pending:
            return
        t0 = time.monotonic_ns()
        items = sorted(self._pending.items())
        self._pending = {}
        slots_np = np.array([s for s, _ in items], np.int64)
        slots = torch.from_numpy(slots_np).to(self.device)
        rows = torch.from_numpy(np.stack(
            [np.zeros(self.dim, np.float32) if v is None else v for _, v in items]
        )).to(self.device)
        alive = torch.tensor([v is not None for _, v in items], dtype=torch.bool,
                             device=self.device)
        n = len(items)
        updates = []  # (attribute, rows to scatter at ``slots``)
        if self.is_pq:
            if self.codebook is None and any(v is not None for _, v in items):
                # lazy train on the first synced batch (the reference's
                # contract: the first ingest is the training sample)
                self.codebook = self._train(rows[alive])
            if self.codebook is None:  # an all-deletes batch before any data
                u_pq = self._zeros((n, self.pq_width), torch.uint8)
                u_sqnorm = self._zeros((n,), torch.float32)
            else:
                u_pq, u_sqnorm = pq_encode(rows, self.codebook)
            if self.pq_cache:
                if self.codebook is None:
                    u_codes = self._zeros((n, self.dim), torch.float8_e4m3fn)
                    u_scale = self._ones((n, 1))
                else:
                    u_codes, u_scale, u_sqnorm = pq_cache_rows(u_pq, self.codebook)
                if self.pq_host:
                    table = self.pqcodes_host
                    if self._readers:
                        table = table.copy()
                    table[slots_np] = u_pq.cpu().numpy()
                    self.pqcodes_host = table
                else:
                    updates.append(("pqcodes", u_pq))
            else:
                u_codes, u_scale = u_pq, self._ones((n, 1))
        elif self.is_bq:
            u_codes = bq_encode(rows)
            u_scale = self._ones((n, 1))
            u_sqnorm = self._zeros((n,), torch.float32)
            if self.bq_rerank:
                rr, rr_s = quantize(rows, self.bq_rr_quant)
                updates += [("rr_codes", rr), ("rr_scale", rr_s)]
        else:
            u_codes, u_scale = quantize(rows, self.quantization)
            deq = dequantize(u_codes, u_scale)
            u_sqnorm = (deq * deq).sum(dim=1)
        updates += [("codes", u_codes), ("scale", u_scale), ("sqnorm", u_sqnorm),
                    ("valid", alive)]
        for name, src in updates:
            setattr(self, name, scatter_rows(getattr(self, name), slots_np, slots,
                                             src, inplace=self._readers == 0))
        trace.record("store.sync", None, t0, time.monotonic_ns())

    def _set_keys(self, pk_to_slot: Dict[str, int]) -> None:
        """Replace the slot maps whole (a load, an adoption, a conversion),
        after ``capacity`` is final."""
        self.pk_to_slot = dict(pk_to_slot)
        self.slot_to_pk = {slot: pk for pk, slot in self.pk_to_slot.items()}
        self.pk_col = np.full(self.capacity, "", object)
        self.pk_col[list(self.slot_to_pk)] = list(self.slot_to_pk.values())

    # -- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.pk_to_slot)

    def pks_at(self, slots: np.ndarray) -> List[str]:
        """The primary keys at ``slots`` (each >= 0), in one gather; ""
        where a slot holds no row."""
        return self.pk_col[slots].tolist()

    @property
    def memory_bytes(self) -> int:
        """Device bytes of the store's tensors (a host code table excluded)."""
        per_row = self._row_width * self._qdtype.itemsize + 4 + 4 + 1
        if self.pq_host:
            per_row -= self._row_width  # codes live on the host
        if self.pq_cache:
            per_row += self.dim  # f8 scan cache
        if self.bq_rerank:
            per_row += self.dim * storage_dtype(self.bq_rr_quant).itemsize + 4
        return self.capacity * per_row

    @_locked
    def get_vector(self, pk: str) -> Optional[np.ndarray]:
        slot = self.pk_to_slot.get(pk)
        if slot is None:
            return None
        pend = self._pending.get(slot)
        if pend is not None:
            return pend.copy()
        self.sync()
        if self.is_pq:
            if self.codebook is None:
                return None
            row = torch.as_tensor(state_row(self._pq_code_array(), slot)).to(self.device)
            return pq_reconstruct(row[None], self.codebook, derotate=True)[0].cpu().numpy()
        if self.is_bq:
            if self.bq_rerank:
                row = state_row(self.rr_codes, slot).to(torch.float32).cpu().numpy()
                return row * float(state_row(self.rr_scale, slot)[0])
            return bq_decode(state_row(self.codes, slot)[None], self.dim)[0].cpu().numpy()
        row = state_row(self.codes, slot).to(torch.float32).cpu().numpy()
        return row * float(state_row(self.scale, slot)[0])

    def search(
        self,
        queries: np.ndarray,
        k: int,
        *,
        candidates: Optional[np.ndarray] = None,
        metric: Optional[Metric] = None,
        fused: bool = False,
        oversample: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k scan. Returns ``(scores [Q,k], slots [Q,k])`` as numpy;
        empty slots carry score -inf and slot -1. ``candidates`` is an
        optional dense int32 array of allowed slots (from the inverted
        index) — the filtered path. ``fused`` selects the fused kernel K1
        where the store's shape supports it (the plain scan otherwise).
        ``oversample > 1``: on a PQ-cache store, shortlist
        ``k * oversample`` rows from the f8 cache (through K1 when
        ``fused``) and rerank them against the exact reconstruction; on a
        BQ store, it overrides ``bq_oversample``. Other modes ignore it,
        and BQ ignores ``fused``.

        Locking: only sync() and a shallow snapshot of the tensor
        references run under the store lock; the scan runs outside it, so
        concurrent searches overlap and upserts are not blocked. While the
        snapshot is live, sync() writes out of place (see sync)."""
        with self._mu:
            self.sync()
            self._readers += 1
            snap = copy.copy(self)  # shallow: shares the tensor references
        try:
            return snap._search_unlocked(
                queries, k, candidates=candidates, metric=metric, fused=fused,
                oversample=oversample,
            )
        finally:
            with self._mu:
                self._readers -= 1

    def _empty(self, q: int, k: int):
        return np.full((q, k), -np.inf, np.float32), np.full((q, k), -1, np.int32)

    def _search_unlocked(self, queries, k, *, candidates=None, metric=None,
                         fused=False, oversample=1):
        """search() body on an already-synced snapshot (see search)."""
        metric = self.metric if metric is None else Metric.parse(metric)
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != collection dim {self.dim}"
            )
        k = max(1, int(k))
        # gRPC hands a read-only buffer; torch wants writable memory
        tq = torch.from_numpy(np.require(queries, requirements="W")).to(self.device)
        if self.pq_cache and self.codebook is not None:
            # the f8 cache stores OPQ-rotated reconstructions
            tq = self.codebook.rotate(tq)
        valid = self.valid
        if candidates is not None:
            candidates = np.asarray(candidates, np.int64).reshape(-1)
            if candidates.size == 0:
                return self._empty(queries.shape[0], k)
            # a sharded store always masks the scan: gathering would pull
            # the candidate rows across shards
            if self.mesh is None and candidates.size < max(
                    k, self.capacity // _GATHER_FRACTION):
                cand = torch.from_numpy(candidates).to(self.device)
                return self._search_gathered(tq, cand, k, metric, oversample)
            mask = torch.zeros(self.capacity, dtype=torch.bool)
            mask[torch.from_numpy(candidates)] = True
            valid = (valid & mask.to(self.device) if self.mesh is None else
                     valid.map(lambda t, lo, hi: t & mask[lo:hi].to(t.device)))

        if self.is_bq:
            if metric != Metric.COSINE:
                raise ValueError("BQ collections are cosine-only")
            return self._search_bq(tq, valid, k, oversample)
        kk = min(k, self.capacity)
        where = self._where
        centroids, rotation, coarse = self._codebook_arrays()
        if self.is_pq and not self.pq_cache:
            if self.codebook is None:  # nothing ever synced
                return self._empty(queries.shape[0], k)
            scores, slots = sharded_pq_topk(
                where, self.codes, centroids, self.sqnorm, valid, tq, k=kk,
                metric=metric, compute_dtype=self.compute_dtype,
                rotation=rotation, coarse=coarse,
            )
        else:
            # the PQ cache's shortlist of k * oversample rows is reranked
            # against the exact reconstruction (a host code table's rows
            # gathered on the host); ``tq`` is already rotated
            pq_rr = None
            if self.pq_cache and self.codebook is not None and oversample > 1:
                pq_rr = (self.pqcodes_host if self.pq_host else self.pqcodes,
                         centroids, coarse)
            scores, slots = sharded_scan_topk(
                where, self.codes, self.scale, self.sqnorm, valid, tq, k=kk,
                metric=metric, compute_dtype=self.compute_dtype, fused=fused,
                oversample=oversample, pq_rerank=pq_rr,
            )
        return self._trim(*_fetch(scores, slots), k)

    def _codebook_arrays(self):
        """``(centroids, rotation, coarse)`` of the codebook as the scans
        take them: tensors, or on a mesh ``{device: tensor}`` replicas made
        once per codebook. Nones without a codebook."""
        cb = self.codebook
        if cb is None:
            return None, None, None
        if self.mesh is None:
            return cb.centroids, cb.rotation, cb.coarse
        if self._cb_reps is None or self._cb_reps[0] is not cb:
            self._cb_reps = (cb, tuple(replicate(self.mesh, t)
                                       for t in (cb.centroids, cb.rotation, cb.coarse)))
        return self._cb_reps[1]

    def _bq_oversample(self, oversample: int) -> int:
        """``oversample``, or the store's ``bq_oversample`` at 1 when it
        reranks."""
        return oversample if oversample > 1 else (
            self.bq_oversample if self.bq_rerank else 1)

    def _search_bq(self, tq, valid, k: int, oversample: int):
        """Hamming shortlist over the packed bits, then (by default) the
        rerank of the shortlist. ``oversample=1`` uses ``bq_oversample``;
        a store without a rerank copy serves the Hamming values and keeps
        the exact per-block selection. On a mesh each shard shortlists and
        reranks its rows before the merge."""
        scores, slots = sharded_bq_topk(
            self._where, self.codes, valid, self.rr_codes, tq,
            k=min(k, self.capacity), oversample=self._bq_oversample(oversample),
            dim=self.dim, rr_scale=self.rr_scale, compute_dtype=self.compute_dtype)
        return self._trim(*_fetch(scores, slots), k)

    def _search_gathered(self, tq, cand, k, metric, oversample=1):
        """Small-candidate-set regime: gather the rows, scan the tile."""
        n = cand.shape[0]
        if self.is_bq:
            if metric != Metric.COSINE:
                raise ValueError("BQ collections are cosine-only")
            negd, slots = bq_shortlist_topk(
                tq, bq_encode(tq), self.codes[cand], self.valid[cand],
                self.rr_codes, self.rr_scale, k=min(k, n),
                oversample=self._bq_oversample(oversample), dim=self.dim,
                compute_dtype=self.compute_dtype, rows=cand)
            scores = scores_from_negd(negd, Metric.COSINE)
            return self._trim(*_fetch(scores, slots), k)
        if self.is_pq and not self.pq_cache:
            if self.codebook is None:
                return self._empty(tq.shape[0], k)
            scores, local = pq_scan_topk(
                tq, self.codes[cand], self.codebook, self.sqnorm[cand],
                self.valid[cand], k=min(k, n), metric=metric,
                compute_dtype=self.compute_dtype)
        else:
            scores, local = scan_topk(
                tq, self.codes[cand], self.scale[cand], self.sqnorm[cand],
                self.valid[cand], k=min(k, n), metric=metric,
                compute_dtype=self.compute_dtype,
            )
        return self._trim(*_fetch(scores, cand[local.long()]), k)

    @staticmethod
    def _trim(scores, slots, k):
        if scores.shape[1] < k:
            q = scores.shape[0]
            pad = k - scores.shape[1]
            scores = np.concatenate(
                [scores, np.full((q, pad), -np.inf, np.float32)], axis=1
            )
            slots = np.concatenate([slots, np.full((q, pad), -1, np.int32)], axis=1)
        slots = np.where(np.isneginf(scores), -1, slots)
        return scores, slots

    # -- persistence -------------------------------------------------------
    @_locked
    def save(self, f: io.BufferedIOBase) -> None:
        """Binary snapshot, byte-compatible with the JAX package's:
        magic, 8-byte big-endian header length, msgpack header (with a
        ``"bq"`` / ``"pq"`` section, the codebook's bytes inside), then the
        raw codes (PQ: the authoritative code rows) / scale / sqnorm /
        valid bytes, then a BQ store's rerank copy and its scale."""
        self.sync()
        header = {
            "dim": self.dim,
            "metric": int(self.metric),
            "quantization": int(self.quantization),
            "capacity": self.capacity,
            "next_slot": self._next_slot,
            "free": self._free,
            "pks": [[pk, slot] for pk, slot in self.pk_to_slot.items()],
        }
        if self.is_bq:
            header["bq"] = {
                "rerank": self.bq_rerank,
                "oversample": self.bq_oversample,
                "rerank_dtype": int(self.bq_rr_quant),
            }
        if self.is_pq:
            cb = io.BytesIO()
            if self.codebook is not None:
                self.codebook.save(cb)
            header["pq"] = {
                "m": self.pq_m,
                "centroids": self.pq_centroids,
                "train_iters": self.pq_train_iters,
                "opq_iters": self.pq_opq_iters,
                "coarse": self.pq_coarse,
                "cache": self.pq_cache,
                "codebook": cb.getvalue(),
            }
        hb = msgpack.packb(header, use_bin_type=True)
        f.write(_SNAPSHOT_MAGIC)
        f.write(len(hb).to_bytes(8, "big"))
        f.write(hb)
        codes = self._pq_code_array() if self.is_pq else self.codes
        for t in (codes, self.scale, self.sqnorm, self.valid):
            write_rows(f, t)
        if self.bq_rerank:
            # the sign bits are lossy; the rerank copy is authoritative
            write_rows(f, self.rr_codes)
            write_rows(f, self.rr_scale)

    @classmethod
    def load(
        cls,
        f: io.BufferedIOBase,
        *,
        device="cuda",
        pq_cache: Optional[bool] = None,
        pq_host_codes: Optional[bool] = None,
    ) -> "FlatStore":
        """Load a snapshot of either package. ``pq_cache`` overrides the
        snapshot's; ``pq_host_codes=None`` keeps a PQ-cache store's code
        table on the host when it passes :data:`PQ_HOST_CODES_BYTES`."""
        magic = f.read(len(_SNAPSHOT_MAGIC))
        if magic != _SNAPSHOT_MAGIC:
            raise ValueError("not a FlatStore snapshot")
        hlen = int.from_bytes(f.read(8), "big")
        header = msgpack.unpackb(f.read(hlen), raw=False)
        pq = header.get("pq")
        bq = header.get("bq")
        cap = header["capacity"]
        if pq_cache is None:
            pq_cache = pq.get("cache", True) if pq else True
        if pq_host_codes is None:
            width = pq["m"] + (2 if pq.get("coarse") else 0) if pq else 0
            pq_host_codes = bool(pq and pq_cache and cap * width > PQ_HOST_CODES_BYTES)
        store = cls(
            header["dim"],
            metric=Metric.parse(header["metric"]),
            quantization=Quantization.parse(header["quantization"]),
            device=device,
            pq_subspaces=pq["m"] if pq else None,
            pq_centroids=pq["centroids"] if pq else 256,
            pq_train_iters=pq["train_iters"] if pq else 15,
            pq_opq_iters=pq.get("opq_iters", 0) if pq else 0,
            pq_coarse=pq.get("coarse", 0) if pq else 0,
            pq_cache=pq_cache,
            pq_host_codes=pq_host_codes,
            bq_rerank=bq.get("rerank", True) if bq else True,
            bq_oversample=bq.get("oversample", 64) if bq else 64,
            bq_rerank_dtype=Quantization.parse(
                bq.get("rerank_dtype", int(Quantization.BF16))) if bq
            else Quantization.BF16,
        )
        if pq and pq["codebook"]:
            store.codebook = PQCodebook.load(io.BytesIO(pq["codebook"]),
                                             device=store.device)
        width, qdt = store._row_width, store._qdtype
        codes = tensor_from_bytes(f.read(cap * width * qdt.itemsize), qdt, (cap, width))
        scale = tensor_from_bytes(f.read(cap * 4), torch.float32, (cap, 1))
        sqnorm = tensor_from_bytes(f.read(cap * 4), torch.float32, (cap,))
        valid = tensor_from_bytes(f.read(cap), torch.bool, (cap,))
        store.capacity = cap
        store.valid = valid.to(store.device)
        if store.pq_host:
            store.pqcodes_host = codes.numpy()
            store._rebuild_pq_cache()
        elif store.pq_cache:
            store.pqcodes = codes.to(store.device)
            store._rebuild_pq_cache()
        elif store.is_pq:
            store.codes = codes.to(store.device)
            store.scale = store._ones((cap, 1))
            store.sqnorm = (pq_sqnorm(store.codes, store.codebook)
                            if store.codebook is not None
                            else store._zeros((cap,), torch.float32))
        else:
            store.codes = codes.to(store.device)
            store.scale = scale.to(store.device)
            store.sqnorm = sqnorm.to(store.device)
        if store.bq_rerank:
            rdt = storage_dtype(store.bq_rr_quant)
            d = store.dim
            store.rr_codes = tensor_from_bytes(
                f.read(cap * d * rdt.itemsize), rdt, (cap, d)).to(store.device)
            store.rr_scale = tensor_from_bytes(
                f.read(cap * 4), torch.float32, (cap, 1)).to(store.device)
        store._fit_layout()
        store._next_slot = header["next_slot"]
        store._free = list(header["free"])
        store._set_keys({pk: slot for pk, slot in header["pks"]})
        return store

    @classmethod
    def adopt_pq(
        cls,
        codebook: PQCodebook,
        pqcodes,
        *,
        metric: Metric = Metric.COSINE,
        pq_cache: bool = True,
        device="cuda",
    ) -> "FlatStore":
        """Adopt pre-encoded PQ code rows (``[N, code_width]`` uint8, N a
        multiple of 8192; numpy or a tensor) as a live store whose primary
        keys are the stringified row indices: the bulk path for corpora
        encoded slab-wise with ``pq_encode``. A PQ-cache store builds its
        f8 scan cache from the codes."""
        n, cw = pqcodes.shape
        if n % _CAPACITY_QUANTUM:
            raise ValueError(
                f"adopt_pq needs rows % {_CAPACITY_QUANTUM} == 0, got {n}")
        coarse_c = 0 if codebook.coarse is None else int(codebook.coarse.shape[0])
        m = cw - (2 if coarse_c else 0)
        if m != codebook.m:
            raise ValueError(
                f"code width {cw} does not match codebook "
                f"(m={codebook.m}, coarse={coarse_c})")
        store = cls(
            codebook.dim, metric=metric, quantization=Quantization.PQ,
            device=device, pq_subspaces=m, pq_centroids=codebook.n_centroids,
            pq_coarse=coarse_c, pq_cache=pq_cache,
        )
        store.capacity = n
        store.codebook = codebook.to(store.device)
        pqcodes = torch.as_tensor(pqcodes).to(store.device)
        if store.pq_cache:
            store.pqcodes = pqcodes
            store._rebuild_pq_cache()
        else:
            store.codes = pqcodes
            store.scale = store._ones((n, 1))
            store.sqnorm = pq_sqnorm(pqcodes, store.codebook)
        store.valid = torch.ones(n, dtype=torch.bool, device=store.device)
        store._fit_layout()
        store._set_keys({str(i): i for i in range(n)})
        store._next_slot = n
        return store

    _REBUILD_SLAB = 1 << 20  # host code rows uploaded per step

    def _rebuild_pq_cache(self) -> None:
        """Decompress the authoritative PQ codes into the f8 scan cache
        (once per load). A host code table goes up a slab at a time."""
        if self.codebook is None:
            return
        if not self.pq_host:
            self.codes, self.scale, self.sqnorm = pq_cache_rows(
                self.pqcodes, self.codebook)
            return
        parts = [pq_cache_rows(torch.from_numpy(
                     self.pqcodes_host[off:off + self._REBUILD_SLAB]).to(self.device),
                     self.codebook)
                 for off in range(0, self.capacity, self._REBUILD_SLAB)]
        self.codes, self.scale, self.sqnorm = (torch.cat(p) for p in zip(*parts))

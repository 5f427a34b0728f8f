"""FLAT quantized vector store with slot-based mutation, on torch tensors.

Port of ``coltt_tpu/store/flat.py``, dense modes (none / f16 / bf16 / f8 /
i8). Vectors live in a dense ``[capacity, D]`` tensor in storage dtype on
the store's device, with a per-row fp32 scale, the squared norms of the
dequantized rows, and a validity (tombstone) mask. Mutation is slot-based
and staged:

- upsert resolves the primary key to an existing slot (overwrite) or pops
  a free slot / appends; rows are staged host-side and applied at the next
  ``sync`` in one batched scatter, quantized on the device;
- delete tombstones the slot (valid=False) and returns it to the free list;
- capacity grows by doubling from 8192 rows, so the fused kernel's shape
  rules always hold.

Search is the blocked scan (:mod:`coltt_tpu_torch.ops.topk`) or, with
``fused=True`` where :func:`~coltt_tpu_torch.ops.fused_scan.supports`
holds, the fused kernel K1. Filtered search gathers the candidate rows when
there are few (``capacity // 6``, a crossover measured for the JAX package
and kept as a tunable default) and masks a full scan otherwise.

PQ and BQ are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import copy
import io
import threading
from typing import Dict, List, Optional, Tuple

import msgpack
import numpy as np
import torch

from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.fused_scan import fused_scan_topk
from coltt_tpu_torch.ops.fused_scan import supports as fused_supports
from coltt_tpu_torch.ops.quant import Quantization, dequantize, quantize, storage_dtype
from coltt_tpu_torch.ops.topk import fetch_scores_ids, scan_topk

_CAPACITY_QUANTUM = 8192
# candidate-count fraction below which the gather regime wins the masked
# scan; measured for the JAX package, not yet on the card
_GATHER_FRACTION = 6

_SNAPSHOT_MAGIC = b"CTTFLAT1"

# numpy has no bf16 / f8 dtype: snapshot bytes go through an integer view
# of the same width
_INT_VIEW = {1: torch.int8, 2: torch.int16, 4: torch.int32}

_NOT_PORTED = {
    Quantization.PQ: "PQ",
    Quantization.BQ: "BQ",
}


def _round_capacity(n: int) -> int:
    cap = _CAPACITY_QUANTUM
    while cap < n:
        cap *= 2
    return cap


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, {what})")


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


def _locked(fn):
    """Serialize a FlatStore method under the store lock (search releases
    it for the scan itself; see :meth:`FlatStore.search`). RLock: search ->
    sync re-enters."""
    def wrapper(self, *a, **kw):
        with self._mu:
            return fn(self, *a, **kw)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


class FlatStore:
    """Quantized FLAT store over dense slots on one torch device."""

    def __init__(
        self,
        dim: int,
        *,
        metric: Metric = Metric.COSINE,
        quantization: Quantization = Quantization.NONE,
        compute_dtype=None,
        device="cuda",
    ):
        self._mu = threading.RLock()
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        self.quantization = Quantization.parse(quantization)
        if self.quantization in _NOT_PORTED:
            raise _not_ported(_NOT_PORTED[self.quantization])
        self.device = torch.device(device)
        self._qdtype = storage_dtype(self.quantization)
        # unquantized stores scan in full f32; quantized stores multiply
        # bf16 operands (their codes carry less than bf16 anyway)
        if compute_dtype is None:
            compute_dtype = (
                torch.float32 if self.quantization == Quantization.NONE
                else torch.bfloat16
            )
        self.compute_dtype = compute_dtype

        self._alloc(_CAPACITY_QUANTUM)

        self.pk_to_slot: Dict[str, int] = {}
        self.slot_to_pk: Dict[int, str] = {}
        self._free: List[int] = []
        self._next_slot = 0

        # staged mutations: slot -> (f32 row | None for delete)
        self._pending: Dict[int, Optional[np.ndarray]] = {}
        # live unlocked-search snapshots (see search / sync)
        self._readers = 0

    # -- device state ------------------------------------------------------
    def _zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _alloc(self, cap: int) -> None:
        self.codes = self._zeros((cap, self.dim), self._qdtype)
        self.scale = torch.ones((cap, 1), dtype=torch.float32, device=self.device)
        self.sqnorm = self._zeros((cap,), torch.float32)
        self.valid = self._zeros((cap,), torch.bool)
        self.capacity = cap

    def _grow(self, need: int) -> None:
        # new tensors (torch.cat), so live search snapshots keep the old ones
        new_cap = _round_capacity(need)
        pad = new_cap - self.capacity
        self.codes = torch.cat([self.codes, self._zeros((pad, self.dim), self._qdtype)])
        self.scale = torch.cat([
            self.scale,
            torch.ones((pad, 1), dtype=torch.float32, device=self.device)])
        self.sqnorm = torch.cat([self.sqnorm, self._zeros((pad,), torch.float32)])
        self.valid = torch.cat([self.valid, self._zeros((pad,), torch.bool)])
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
            self._pending[slot] = vec
            slots.append(slot)
        return slots

    @_locked
    def delete(self, pk: str) -> Optional[int]:
        """Tombstone + free the slot (RemoveVertex parity,
        edge/f16_vectorstore.go:108-130)."""
        slot = self.pk_to_slot.pop(pk, None)
        if slot is None:
            return None
        self.slot_to_pk.pop(slot, None)
        self._pending[slot] = None
        self._free.append(slot)
        return slot

    @_locked
    def sync(self) -> None:
        """Apply staged mutations in one batched scatter, quantizing on
        the device and recomputing ``sqnorm`` from the dequantized rows.

        Writes in place when no search snapshot is live; while one is
        (``_readers > 0``), writes out of place so the snapshot's tensors
        never change under its scan."""
        if not self._pending:
            return
        items = sorted(self._pending.items())
        self._pending = {}
        slots = torch.tensor([s for s, _ in items], dtype=torch.int64,
                             device=self.device)
        rows = np.stack(
            [np.zeros(self.dim, np.float32) if v is None else v for _, v in items]
        )
        alive = torch.tensor([v is not None for _, v in items], dtype=torch.bool,
                             device=self.device)
        u_codes, u_scale = quantize(torch.from_numpy(rows).to(self.device),
                                    self.quantization)
        deq = dequantize(u_codes, u_scale)
        u_sqnorm = (deq * deq).sum(dim=1)
        updates = ((self.codes, u_codes), (self.scale, u_scale),
                   (self.sqnorm, u_sqnorm), (self.valid, alive))
        if self._readers == 0:
            for dst, src in updates:
                dst.index_put_((slots,), src)
        else:
            self.codes, self.scale, self.sqnorm, self.valid = (
                dst.index_put((slots,), src) for dst, src in updates
            )

    # -- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.pk_to_slot)

    @property
    def memory_bytes(self) -> int:
        """Device bytes of the store's tensors."""
        return self.capacity * (self.dim * self._qdtype.itemsize + 4 + 4 + 1)

    @_locked
    def get_vector(self, pk: str) -> Optional[np.ndarray]:
        slot = self.pk_to_slot.get(pk)
        if slot is None:
            return None
        pend = self._pending.get(slot)
        if pend is not None:
            return pend.copy()
        self.sync()
        row = self.codes[slot].to(torch.float32).cpu().numpy()
        return row * float(self.scale[slot, 0])

    def search(
        self,
        queries: np.ndarray,
        k: int,
        *,
        candidates: Optional[np.ndarray] = None,
        metric: Optional[Metric] = None,
        fused: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k scan. Returns ``(scores [Q,k], slots [Q,k])`` as numpy;
        empty slots carry score -inf and slot -1. ``candidates`` is an
        optional dense int32 array of allowed slots (from the inverted
        index) — the filtered path. ``fused`` selects the fused kernel K1
        where the store's shape supports it (the plain scan otherwise).

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
            )
        finally:
            with self._mu:
                self._readers -= 1

    def _search_unlocked(self, queries, k, *, candidates=None, metric=None,
                         fused=False):
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
        valid = self.valid
        if candidates is not None:
            candidates = np.asarray(candidates, np.int64).reshape(-1)
            if candidates.size == 0:
                q = queries.shape[0]
                return (
                    np.full((q, k), -np.inf, np.float32),
                    np.full((q, k), -1, np.int32),
                )
            cand = torch.from_numpy(candidates).to(self.device)
            if candidates.size < max(k, self.capacity // _GATHER_FRACTION):
                return self._search_gathered(tq, cand, k, metric)
            mask = torch.zeros(self.capacity, dtype=torch.bool, device=self.device)
            mask[cand] = True
            valid = valid & mask

        if fused and fused_supports(self.capacity, self.dim, metric,
                                    self.codes.dtype):
            scores, slots = fused_scan_topk(
                tq, self.codes, self.scale, self.sqnorm, valid,
                k=min(k, self.capacity), metric=metric,
                compute_dtype=self.compute_dtype,
            )
        else:
            scores, slots = scan_topk(
                tq, self.codes, self.scale, self.sqnorm, valid,
                k=min(k, self.capacity), metric=metric,
                compute_dtype=self.compute_dtype,
            )
        return self._trim(*fetch_scores_ids(scores, slots), k)

    def _search_gathered(self, tq, cand, k, metric):
        """Small-candidate-set regime: gather the rows, scan the tile."""
        scores, local = scan_topk(
            tq, self.codes[cand], self.scale[cand], self.sqnorm[cand],
            self.valid[cand], k=min(k, cand.shape[0]), metric=metric,
            compute_dtype=self.compute_dtype,
        )
        return self._trim(*fetch_scores_ids(scores, cand[local.long()]), k)

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
    _SAVE_ROWS = 131_072  # rows fetched per device->host chunk on save

    @classmethod
    def _write_rows(cls, f, t: torch.Tensor) -> None:
        """Stream a tensor to ``f`` in row chunks, so the host never holds
        more than one chunk of it."""
        for i in range(0, t.shape[0], cls._SAVE_ROWS):
            f.write(tensor_to_bytes(t[i:i + cls._SAVE_ROWS]))

    @_locked
    def save(self, f: io.BufferedIOBase) -> None:
        """Binary snapshot, byte-compatible with the JAX package's:
        magic, 8-byte big-endian header length, msgpack header, then the
        raw codes / scale / sqnorm / valid bytes."""
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
        hb = msgpack.packb(header, use_bin_type=True)
        f.write(_SNAPSHOT_MAGIC)
        f.write(len(hb).to_bytes(8, "big"))
        f.write(hb)
        for t in (self.codes, self.scale, self.sqnorm, self.valid):
            self._write_rows(f, t)

    @classmethod
    def load(cls, f: io.BufferedIOBase, *, device="cuda") -> "FlatStore":
        magic = f.read(len(_SNAPSHOT_MAGIC))
        if magic != _SNAPSHOT_MAGIC:
            raise ValueError("not a FlatStore snapshot")
        hlen = int.from_bytes(f.read(8), "big")
        header = msgpack.unpackb(f.read(hlen), raw=False)
        for key, what in (("pq", "PQ"), ("bq", "BQ")):
            if header.get(key) is not None:
                raise _not_ported(what)
        store = cls(
            header["dim"],
            metric=Metric.parse(header["metric"]),
            quantization=Quantization.parse(header["quantization"]),
            device=device,
        )
        cap = header["capacity"]
        d = store.dim
        qdt = store._qdtype
        store.codes = tensor_from_bytes(
            f.read(cap * d * qdt.itemsize), qdt, (cap, d)).to(store.device)
        store.scale = tensor_from_bytes(
            f.read(cap * 4), torch.float32, (cap, 1)).to(store.device)
        store.sqnorm = tensor_from_bytes(
            f.read(cap * 4), torch.float32, (cap,)).to(store.device)
        store.valid = tensor_from_bytes(
            f.read(cap), torch.bool, (cap,)).to(store.device)
        store.capacity = cap
        store._next_slot = header["next_slot"]
        store._free = list(header["free"])
        store.pk_to_slot = {pk: slot for pk, slot in header["pks"]}
        store.slot_to_pk = {slot: pk for pk, slot in header["pks"]}
        return store

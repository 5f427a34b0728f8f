"""CFLAT weighted multi-vector store on torch tensors.

Port of ``coltt_tpu/store/multivec.py``. Reference parity:
``experimental/multi_vector_vertex.go`` -- records carry several *named*
vectors (the schema's Vector-typed fields); a search takes
``[(index_name, vector, ratio)]`` for the included fields and scores each
record as

    score = sum_f normalize(dist(record.vec[f], query.vec[f])) * ratio_f / 100

(multi_vector_vertex.go:85-138).

One dense ``[capacity, D_f]`` code tensor per field, with its per-row
scale ``[capacity, 1]`` and the squared norms of the dequantized rows
``[capacity]``; all fields share one slot axis and one ``valid`` mask, so
a record is one slot across every field. Mutation is staged as in
``store/flat.py``: upsert / delete resolve the slot, ``sync`` applies the
batch in one scatter per field, quantizing on the device. Capacity grows
by doubling from 8192 rows.

A search scores every included field's rows and takes one top-k of the
weighted sum: :func:`~coltt_tpu_torch.parallel.dist_search.sharded_cflat_topk`,
blocked over rows by free device memory (the reference builds the whole
``[Q, N]`` matrix of every field). The products stay library calls: the
reference computes them in XLA, outside any Pallas kernel, and K1 keeps
one row per 32-row bin of one field, while the weighted sum needs every
field's score of a row first.

Over a :class:`~coltt_tpu_torch.parallel.mesh.Mesh` (``device=mesh``, the
reference's ``mesh``) every field's rows and ``valid`` are
:class:`~coltt_tpu_torch.parallel.mesh.ShardedRows` over one slot axis,
capacity a multiple of ``shards x 8192``; ``sync`` routes rows to their
shard (out of place per touched shard while a search holds the store),
growth re-cuts the blocks, and a search is ``sharded_cflat_topk``'s
shard-local weighted scan and merge.
"""

from __future__ import annotations

import copy
import io
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import msgpack
import numpy as np
import torch

from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization, dequantize, quantize, storage_dtype
from coltt_tpu_torch.ops.topk import fetch_scores_ids
from coltt_tpu_torch.parallel.dist_search import sharded_cflat_topk
from coltt_tpu_torch.parallel.mesh import ShardedRows, split
from coltt_tpu_torch.store.flat import (
    _CAPACITY_QUANTUM,
    _locked,
    _round_capacity,
    grow_rows,
    scatter_rows,
    tensor_from_bytes,
    write_rows,
)

_SNAPSHOT_MAGIC = b"CTTMVEC1"


class MultiVectorStore:
    """Multi-field vector store keyed by string primary key, on one torch
    device or row-sharded over a mesh passed as ``device``."""

    def __init__(
        self,
        fields: Dict[str, int],  # field name -> dim
        *,
        metric: Metric = Metric.COSINE,
        quantization: Quantization = Quantization.NONE,
        base_capacity: int = _CAPACITY_QUANTUM,
        device="cuda",
    ):
        if not fields:
            raise ValueError("multi-vector store needs at least one vector field")
        self.fields = dict(fields)
        self.metric = Metric.parse(metric)
        self.quantization = Quantization.parse(quantization)
        self.mesh, self.device, self._where = split(device, single_as_device=True)
        self._quantum = _CAPACITY_QUANTUM * (self.mesh.shards if self.mesh else 1)
        self._qdtype = storage_dtype(self.quantization)
        self.compute_dtype = (
            torch.float32 if self.quantization == Quantization.NONE else torch.bfloat16
        )
        self.capacity = _round_capacity(base_capacity, self._quantum)
        self.codes: Dict[str, torch.Tensor] = {}
        self.scale: Dict[str, torch.Tensor] = {}
        self.sqnorm: Dict[str, torch.Tensor] = {}
        for name, dim in self.fields.items():
            self.codes[name] = self._state((self.capacity, dim), self._qdtype)
            self.scale[name] = self._state((self.capacity, 1), torch.float32, 1.0)
            self.sqnorm[name] = self._state((self.capacity,), torch.float32)
        self.valid = self._state((self.capacity,), torch.bool, False)

        self.pk_to_slot: Dict[str, int] = {}
        self.slot_to_pk: Dict[int, str] = {}
        self._free: List[int] = []
        self._next_slot = 0
        self._mu = threading.RLock()
        # staged mutations: slot -> {field: f32 row} | None for a delete
        self._pending: Dict[int, Optional[Dict[str, np.ndarray]]] = {}
        # live unlocked-search snapshots (see search / sync)
        self._readers = 0

    def _state(self, shape, dtype, fill=0.0):
        """A new capacity-sized state tensor of ``fill``, made on each
        shard's device on a mesh."""
        if self.mesh is None:
            return torch.full(shape, fill, dtype=dtype, device=self.device)
        return ShardedRows.build(self.mesh, shape[0], lambda lo, hi, d: torch.full(
            (hi - lo, *shape[1:]), fill, dtype=dtype, device=d))

    # -- mutation ----------------------------------------------------------
    def _grow(self, need: int) -> None:
        self._resize(_round_capacity(need, self._quantum))

    def _resize(self, new_cap: int) -> None:
        # new tensors, so live search snapshots keep the old ones
        for name in self.fields:
            self.codes[name] = grow_rows(self.codes[name], new_cap)
            self.scale[name] = grow_rows(self.scale[name], new_cap, 1.0)
            self.sqnorm[name] = grow_rows(self.sqnorm[name], new_cap)
        self.valid = grow_rows(self.valid, new_cap, False)
        self.capacity = new_cap

    def _fit_layout(self) -> None:
        """After the state was set whole on ``self.device`` at ``capacity``
        rows (a load): pad it to the quantum and cut it into the mesh's
        shards."""
        if self.capacity % self._quantum:
            self._resize(_round_capacity(self.capacity, self._quantum))
        if self.mesh is not None:
            place = lambda t: ShardedRows.place(self.mesh, t)  # noqa: E731
            for table in (self.codes, self.scale, self.sqnorm):
                for name in self.fields:
                    table[name] = place(table[name])
            self.valid = place(self.valid)

    @_locked
    def upsert(self, pk: str, vectors: Dict[str, np.ndarray]) -> int:
        missing = set(self.fields) - set(vectors)
        if missing:
            raise ValueError(f"record {pk!r} missing vector fields {sorted(missing)}")
        extra = set(vectors) - set(self.fields)
        if extra:
            raise ValueError(f"record {pk!r} has unknown vector fields {sorted(extra)}")
        clean = {}
        for name, vec in vectors.items():
            vec = np.asarray(vec, np.float32).reshape(-1)
            if vec.shape[0] != self.fields[name]:
                raise ValueError(
                    f"field {name!r}: dim {vec.shape[0]} != schema {self.fields[name]}"
                )
            clean[name] = vec
        slot = self.pk_to_slot.get(pk)
        if slot is None:
            if self._free:
                slot = self._free.pop()
            else:
                slot = self._next_slot
                self._next_slot += 1
                if self._next_slot > self.capacity:
                    self._grow(self._next_slot)
            self.pk_to_slot[pk] = slot
            self.slot_to_pk[slot] = pk
        self._pending[slot] = clean
        return slot

    @_locked
    def delete(self, pk: str) -> Optional[int]:
        slot = self.pk_to_slot.pop(pk, None)
        if slot is None:
            return None
        self.slot_to_pk.pop(slot, None)
        self._pending[slot] = None
        self._free.append(slot)
        return slot

    @_locked
    def sync(self) -> None:
        """Apply the staged mutations: one scatter per field, the rows
        quantized on the device and ``sqnorm`` taken from the dequantized
        rows. In place when no search snapshot is live; while one is
        (``_readers > 0``), out of place, so the snapshot's tensors never
        change under its scan."""
        if not self._pending:
            return
        items = sorted(self._pending.items())
        self._pending = {}
        slots_np = np.array([s for s, _ in items], np.int64)
        slots = torch.from_numpy(slots_np).to(self.device)
        alive = torch.tensor([v is not None for _, v in items], dtype=torch.bool,
                             device=self.device)
        for name, dim in self.fields.items():
            zero = np.zeros(dim, np.float32)
            rows = torch.from_numpy(np.stack(
                [zero if v is None else v[name] for _, v in items])).to(self.device)
            u_codes, u_scale = quantize(rows, self.quantization)
            deq = dequantize(u_codes, u_scale)
            for table, src in ((self.codes, u_codes), (self.scale, u_scale),
                               (self.sqnorm, (deq * deq).sum(dim=1))):
                table[name] = scatter_rows(table[name], slots_np, slots, src,
                                           inplace=self._readers == 0)
        self.valid = scatter_rows(self.valid, slots_np, slots, alive,
                                  inplace=self._readers == 0)

    # -- search ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.pk_to_slot)

    @property
    def memory_bytes(self) -> int:
        item = self._qdtype.itemsize
        per_row = sum(d * item + 8 for d in self.fields.values()) + 1
        return self.capacity * per_row

    def _parse(self, query_fields, *, batch: bool):
        """(names, [Q, Df] f32 tensors, ratios / 100) of the included
        fields, validated as the reference does."""
        names, queries, ratios = [], [], []
        nq = None
        for name, vec, ratio in query_fields:
            if name not in self.fields:
                raise ValueError(f"unknown vector field {name!r}")
            dim = self.fields[name]
            if batch:
                block = np.asarray(vec, np.float32)
                if block.ndim != 2 or block.shape[1] != dim:
                    raise ValueError(
                        f"field {name!r}: query block {block.shape} != [Q, {dim}]")
                if nq is None:
                    nq = block.shape[0]
                elif block.shape[0] != nq:
                    raise ValueError("all query blocks must share the same Q")
            else:
                block = np.asarray(vec, np.float32).reshape(1, -1)
                if block.shape[1] != dim:
                    raise ValueError(
                        f"field {name!r}: query dim {block.shape[1]} != {dim}")
            names.append(name)
            # gRPC hands a read-only buffer; torch wants writable memory
            queries.append(torch.from_numpy(
                np.require(block, requirements="W")).to(self.device))
            ratios.append(float(ratio) / 100.0)
        return names, tuple(queries), tuple(ratios)

    def search(
        self,
        query_fields: Sequence[Tuple[str, np.ndarray, float]],
        k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """CFLAT search: ``query_fields`` is [(field, vector, ratio)] for the
        *included* fields (include_or_not=false entries are simply omitted,
        as the reference treats them as nil). Ratios are percentages; 100
        in total keeps scores on the 0-100 scale. Returns (scores [k],
        slots [k]), -1 slots on dead rows."""
        if not query_fields:
            raise ValueError("at least one included query vector required")
        scores, slots = self._search(query_fields, k, batch=False)
        return scores[0], slots[0]

    def search_batch(
        self,
        query_fields: Sequence[Tuple[str, np.ndarray, float]],
        k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch-native CFLAT search: each entry is (field, [Q, Df] query
        block, ratio%) for the *included* fields; every block shares one
        Q. Returns (scores [Q, k], slots [Q, k]) with -1 slots on dead
        rows."""
        if not query_fields:
            raise ValueError("at least one included query vector block required")
        return self._search(query_fields, k, batch=True)

    def _search(self, query_fields, k, *, batch: bool):
        """Locking as FlatStore.search: only the sync and a shallow
        snapshot of the tensor references run under the store lock; the
        scan runs outside it, and sync writes out of place meanwhile."""
        names, queries, ratios = self._parse(query_fields, batch=batch)
        with self._mu:
            self.sync()
            self._readers += 1
            snap = copy.copy(self)  # shallow: shares the tensor references
            snap.codes, snap.scale, snap.sqnorm = (
                dict(self.codes), dict(self.scale), dict(self.sqnorm))
        try:
            scores, slots = fetch_scores_ids(
                *snap.search_tensors(names, queries, ratios, k))
        finally:
            with self._mu:
                self._readers -= 1
        return scores, np.where(np.isneginf(scores), -1, slots)

    def search_tensors(self, names, queries, ratios, k: int):
        """The scan on device tensors, not waited for: ``names`` of the
        included fields, their ``[Q, Df]`` f32 query tensors on the
        store's device and ratios already divided by 100. Returns
        ``(scores [Q, kk], slots [Q, kk])``, kk = min(k, capacity)."""
        field_state = tuple((self.codes[n], self.scale[n], self.sqnorm[n])
                            for n in names)
        kk = min(max(1, int(k)), self.capacity)
        return sharded_cflat_topk(
            self._where, field_state, self.valid, queries, ratios, k=kk,
            metric=self.metric, compute_dtype=self.compute_dtype)

    # -- persistence -------------------------------------------------------
    @_locked
    def save(self, f: io.BufferedIOBase) -> None:
        """Binary snapshot, byte-compatible with the JAX package's
        ``CTTMVEC1``: magic, 8-byte big-endian header length, msgpack
        header, then per field in sorted order the raw codes, scale and
        sqnorm bytes, then ``valid``."""
        self.sync()
        header = {
            "fields": self.fields,
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
        for name in sorted(self.fields):
            for t in (self.codes[name], self.scale[name], self.sqnorm[name]):
                write_rows(f, t)
        write_rows(f, self.valid)

    @classmethod
    def load(cls, f: io.BufferedIOBase, *, device="cuda") -> "MultiVectorStore":
        """Load a snapshot written by either package."""
        magic = f.read(len(_SNAPSHOT_MAGIC))
        if magic != _SNAPSHOT_MAGIC:
            raise ValueError("not a MultiVectorStore snapshot")
        hlen = int.from_bytes(f.read(8), "big")
        header = msgpack.unpackb(f.read(hlen), raw=False)
        store = cls(
            header["fields"],
            metric=Metric.parse(header["metric"]),
            quantization=Quantization.parse(header["quantization"]),
            base_capacity=_CAPACITY_QUANTUM,  # the state is read below
            device=device,
        )
        cap = header["capacity"]
        qdt = store._qdtype
        for name in sorted(store.fields):
            dim = store.fields[name]
            store.codes[name] = tensor_from_bytes(
                f.read(cap * dim * qdt.itemsize), qdt, (cap, dim)).to(store.device)
            store.scale[name] = tensor_from_bytes(
                f.read(cap * 4), torch.float32, (cap, 1)).to(store.device)
            store.sqnorm[name] = tensor_from_bytes(
                f.read(cap * 4), torch.float32, (cap,)).to(store.device)
        store.valid = tensor_from_bytes(f.read(cap), torch.bool, (cap,)).to(store.device)
        store.capacity = cap
        store._fit_layout()
        store._next_slot = header["next_slot"]
        store._free = list(header["free"])
        store.pk_to_slot = {pk: slot for pk, slot in header["pks"]}
        store.slot_to_pk = {slot: pk for pk, slot in header["pks"]}
        return store

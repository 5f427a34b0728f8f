"""Experimental engine: CFLAT multi-vector collections over an object store.

Port of ``coltt_tpu/engine/experimental.py``. Reference parity:
``experimental/experimental.go`` -- the object-store lifecycle of edge
(objects ``<col>.meta.json`` / ``<col>.vertex``), Index upserting records
that carry several *named* vectors (experimental.go:494-554), and
VectorSearch taking ``[(index_name, vector, include_or_not, ratio)]``
(idl/proto/v3/experimental.proto SearchMultiIndex). The schema declares
Vector-typed fields, which all share the collection dim; the other fields
are filterable metadata in the same inverted index as edge.

The checkpoint objects are byte-compatible with the JAX package's
(``<col>.vertex``: an 8-byte big-endian length, a msgpack side-car of the
metadata and the inverted index, then the ``CTTMVEC1`` store snapshot), so
either engine loads what the other flushed. Every collection's tensors
live on the engine's ``device``, or, given a ``mesh``
(``[serving].shards``), row-sharded over it and searched by
``sharded_cflat_topk``'s shard-local scans and merge.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import msgpack
import numpy as np
import torch

from coltt_tpu_torch.engine.errors import EngineError, ErrorCode
from coltt_tpu_torch.engine.state import CollectionStateManager
from coltt_tpu_torch.index.bitmap import InvertedIndex
from coltt_tpu_torch.index.schema import CollectionSchema, FieldType, SchemaError
from coltt_tpu_torch.parallel.mesh import split
from coltt_tpu_torch.storage.objectstore import LocalObjectStore
from coltt_tpu_torch.store.multivec import MultiVectorStore
from coltt_tpu_torch.utils.logging import get_logger

log = get_logger("experimental")

META_OBJ = "{name}.meta.json"
VERTEX_OBJ = "{name}.vertex"


@dataclass
class _MvCollection:
    schema: CollectionSchema
    store: MultiVectorStore
    inverted: InvertedIndex
    metadata: Dict[int, Dict[str, Any]] = field(default_factory=dict)


@dataclass
class MvSearchHit:
    id: str
    score: float
    metadata: Dict[str, Any]


class ExperimentalEngine:
    def __init__(self, object_store: LocalObjectStore, *, device="cuda", mesh=None):
        # multi-device serving ([serving].shards): every collection's
        # MultiVectorStore shards its rows over this mesh
        self.mesh, self.device, self._placement = split(
            mesh if mesh is not None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch sees no CUDA device")
        self.objects = object_store
        self.state = CollectionStateManager()
        self._collections: Dict[str, _MvCollection] = {}
        self._mu = threading.RLock()
        for bucket in self.objects.list_buckets():
            if self.objects.object_exists(bucket, META_OBJ.format(name=bucket)):
                self.state.add(bucket)

    # -- lifecycle -----------------------------------------------------------
    def create_collection(self, schema: CollectionSchema) -> dict:
        with self._mu:
            self.state.require_not_exists(schema.name)
            if not schema.vector_fields:
                raise EngineError(
                    "experimental collections need at least one Vector-typed field"
                )
            col = _MvCollection(
                schema=schema,
                store=MultiVectorStore(
                    {f: schema.dim for f in schema.vector_fields},
                    metric=schema.metric,
                    quantization=schema.quantization,
                    device=self._placement,
                ),
                inverted=InvertedIndex(
                    fields=[f.name for f in schema.fields if f.type != FieldType.VECTOR]
                ),
            )
            self.objects.create_bucket(schema.name, versioning=schema.versioning)
            self._collections[schema.name] = col
            self.state.add(schema.name)
            self.state.mark_loaded(schema.name)
            self._flush_objects(schema.name, col)
            return self.get_collection(schema.name)

    def delete_collection(self, name: str) -> None:
        with self._mu:
            self._collections.pop(name, None)
            self.objects.delete_bucket(name)
            self.state.remove(name)

    def get_collection(self, name: str) -> dict:
        self.state.require_exists(name)
        with self._mu:
            col = self._collections.get(name)
            if col is None:
                raw = self.objects.get_object(name, META_OBJ.format(name=name))
                if raw is None:
                    raise EngineError(f"collection {name!r} metadata missing")
                return {
                    "schema": CollectionSchema.from_dict(json.loads(raw)),
                    "size": 0, "memory_bytes": 0, "loaded": False,
                }
            return {
                "schema": col.schema,
                "size": len(col.store),
                "memory_bytes": col.store.memory_bytes,
                "loaded": self.state.loaded(name),
            }

    def load_collection(self, name: str) -> dict:
        with self._mu:
            self.state.require_exists(name)
            if self.state.loaded(name) and name in self._collections:
                return self.get_collection(name)
            raw_meta = self.objects.get_object(name, META_OBJ.format(name=name))
            vertex_f = self.objects.open_object(name, VERTEX_OBJ.format(name=name))
            if raw_meta is None or vertex_f is None:
                if vertex_f is not None:
                    vertex_f.close()
                raise EngineError(f"collection {name!r} checkpoint incomplete")
            schema = CollectionSchema.from_dict(json.loads(raw_meta))
            # streamed: the store decodes array by array
            try:
                side_len = int.from_bytes(vertex_f.read(8), "big")
                side = msgpack.unpackb(vertex_f.read(side_len), raw=False)
                store = MultiVectorStore.load(vertex_f, device=self._placement)
            finally:
                vertex_f.close()
            col = _MvCollection(
                schema=schema,
                store=store,
                inverted=InvertedIndex.from_bytes(side["inverted"]),
                metadata={int(s): m for s, m in side["metadata"]},
            )
            self._collections[name] = col
            self.state.mark_loaded(name)
            return self.get_collection(name)

    def release_collection(self, name: str) -> None:
        with self._mu:
            self.state.require_exists(name)
            col = self._collections.pop(name, None)
            if col is not None:
                self._flush_objects(name, col)
            self.state.mark_released(name)

    def flush(self, name: str) -> None:
        with self._mu:
            self.state.require_loaded(name)
            self._flush_objects(name, self._collections[name])

    def close(self) -> None:
        with self._mu:
            for name in list(self.state.loaded_collections()):
                col = self._collections.get(name)
                if col is not None:
                    self._flush_objects(name, col)

    # -- mutation ------------------------------------------------------------
    def index(
        self,
        name: str,
        record_id: str,
        vectors: Optional[Dict[str, np.ndarray]] = None,
        metadata: Optional[Dict[str, Any]] = None,
        *,
        delete: bool = False,
    ) -> None:
        with self._mu:
            self.state.require_loaded(name)
            col = self._collections[name]
            if not record_id:
                raise EngineError("record id required")
            if delete:
                slot = col.store.delete(record_id)
                if slot is not None:
                    col.inverted.remove(slot, col.metadata.pop(slot, None))
                return
            try:
                md = col.schema.analyze_insert(metadata or {})
            except SchemaError as e:
                raise EngineError(str(e), ErrorCode.INTERNAL_FUNC_ERROR) from e
            if not vectors:
                raise EngineError("vectors required for insert/update")
            try:
                slot = col.store.upsert(record_id, vectors)
            except ValueError as e:
                raise EngineError(str(e), ErrorCode.INTERNAL_FUNC_ERROR) from e
            self._set_metadata(col, slot, md)

    @staticmethod
    def _set_metadata(col: _MvCollection, slot: int, md: Dict[str, Any]) -> None:
        old = col.metadata.get(slot)
        if old is not None:
            col.inverted.remove(slot, old)
        col.metadata[slot] = md
        col.inverted.add(slot, md)

    def index_many(
        self,
        name: str,
        record_ids: List[str],
        vectors_by_field: Dict[str, np.ndarray],  # field -> [N, dim_f]
        metadatas: Optional[List[Dict[str, Any]]] = None,
    ) -> int:
        """Bulk upsert (BulkIndex RPC; no reference analogue -- its gRPC
        path is one by one). Every id and metadata row is validated before
        the first upsert, so a bad row applies nothing; one store sync
        covers the whole batch."""
        with self._mu:
            self.state.require_loaded(name)
            col = self._collections[name]
            n = len(record_ids)
            if n == 0:
                return 0
            metadatas = metadatas or [{} for _ in range(n)]
            if len(metadatas) != n:
                raise EngineError("metadata must parallel rows")
            for fname, block in vectors_by_field.items():
                if np.asarray(block).shape[0] != n:
                    raise EngineError(f"field {fname!r}: block rows != len(ids)")
            if not all(record_ids):
                raise EngineError("record id required")
            try:
                mds = [col.schema.analyze_insert(m) for m in metadatas]
            except SchemaError as e:
                raise EngineError(str(e), ErrorCode.INTERNAL_FUNC_ERROR) from e
            for i, rid in enumerate(record_ids):
                try:
                    slot = col.store.upsert(
                        rid, {f: b[i] for f, b in vectors_by_field.items()})
                except ValueError as e:
                    raise EngineError(str(e), ErrorCode.INTERNAL_FUNC_ERROR) from e
                self._set_metadata(col, slot, mds[i])
            col.store.sync()
            return n

    # -- search --------------------------------------------------------------
    def _included(self, name: str, query_fields):
        """The collection and its (field, vector, ratio) included entries."""
        with self._mu:
            self.state.require_loaded(name)
            col = self._collections[name]
        included = [(n, v, r) for (n, v, inc, r) in query_fields if inc]
        if not included:
            raise EngineError("no included query vectors")
        return col, included

    def vector_search(
        self,
        name: str,
        query_fields: Sequence[Tuple[str, np.ndarray, bool, float]],
        top_k: int = 10,
        *,
        high_resource: bool = False,  # API parity; the scan is always parallel
    ) -> List[MvSearchHit]:
        """query_fields: (index_name, vector, include_or_not, ratio%)."""
        del high_resource
        col, included = self._included(name, query_fields)
        try:
            scores, slots = col.store.search(included, k=top_k)
        except ValueError as e:
            raise EngineError(str(e), ErrorCode.INTERNAL_FUNC_ERROR) from e
        return [
            MvSearchHit(id=col.store.slot_to_pk.get(int(slot), ""),
                        score=float(score),
                        metadata=col.metadata.get(int(slot), {}))
            for score, slot in zip(scores, slots)
            if slot >= 0 and np.isfinite(score)
        ]

    def vector_search_batch(
        self,
        name: str,
        query_fields: Sequence[Tuple[str, np.ndarray, bool, float]],
        top_k: int = 10,
        *,
        with_metadata: bool = False,
    ):
        """Batch-native CFLAT search (VectorSearchBatch RPC path): each
        entry is (index_name, [Q, Df] query block, include_or_not, ratio%).

        Returns columnar results in the SearchBatchResponse wire shape:
        ``(counts [Q], scores flat, ids flat, metadatas flat | None)``;
        query q owns rows [sum(counts[:q]), sum(counts[:q+1]))."""
        col, included = self._included(name, query_fields)
        t0 = time.perf_counter()
        try:
            scores, slots = col.store.search_batch(included, k=max(1, int(top_k)))
        except ValueError as e:
            raise EngineError(str(e), ErrorCode.INTERNAL_FUNC_ERROR) from e
        scan_s = time.perf_counter() - t0
        keep = (slots >= 0) & np.isfinite(scores)
        counts = keep.sum(axis=1).tolist()
        flat = keep.ravel()
        out_scores = scores.ravel()[flat].tolist()
        flat_slots = slots.ravel()[flat]
        pk_of = col.store.slot_to_pk
        out_ids = [pk_of.get(int(s), "") for s in flat_slots]
        out_mds: Optional[List[Dict[str, Any]]] = None
        if with_metadata:
            md_of = col.metadata
            out_mds = [md_of.get(int(s), {}) for s in flat_slots]
        log.debug(
            "vector_search_batch",
            extra={"kv": {
                "collection": name, "q": int(scores.shape[0]),
                "scan_ms": round(scan_s * 1e3, 2),
            }},
        )
        return counts, out_scores, out_ids, out_mds

    # -- checkpoint ------------------------------------------------------------
    def _flush_objects(self, name: str, col: _MvCollection) -> None:
        side = msgpack.packb(
            {
                "metadata": [[s, m] for s, m in col.metadata.items()],
                "inverted": col.inverted.to_bytes(),
            },
            use_bin_type=True,
        )

        def write_vertex(f):
            # the side-car, then the store's row-chunked snapshot
            f.write(len(side).to_bytes(8, "big"))
            f.write(side)
            col.store.save(f)

        self.objects.put_object(
            name, META_OBJ.format(name=name),
            json.dumps(col.schema.to_dict()).encode(),
        )
        self.objects.put_object_stream(name, VERTEX_OBJ.format(name=name), write_vertex)
        if self.objects.bucket_versioning(name):
            for obj in (META_OBJ, VERTEX_OBJ):
                self.objects.cleanup_versions(name, obj.format(name=name), keep=2)

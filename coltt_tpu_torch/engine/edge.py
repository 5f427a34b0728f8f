"""Edge engine: quantized FLAT collections over an object store.

Port of ``coltt_tpu/engine/edge.py``. Reference parity: ``edge/edge.go`` +
``root_layer/edge-lite`` — collection lifecycle (CreateCollection provisions
a bucket + writes the three checkpoint objects ``<col>.meta.json`` /
``<col>.vertex`` / ``<col>.inverted.raw``; LoadCollection rehydrates them;
Flush re-uploads; Close flushes every loaded collection), Index
upsert/delete with schema analysis, and Search with an optional filter
expression returning 0-100 scores + metadata.

The checkpoint objects are byte-compatible with the JAX package's, so
either engine loads what the other flushed. Every collection's tensors live
on the engine's ``device``, or, given a ``mesh`` (``[serving].shards``),
row-sharded over it: every search is then the shard-local scan and merge
of ``parallel/dist_search.py``, the reference's goroutine-per-shard scan
(edge/f16_vectorstore.go:138-170) as devices.
``high_resource_avaliable`` (the reference's highCpu toggle) selects the
fused scan kernel where the store's shape supports it; the default scan is
the plain exact one. BQ collections scan
their packed sign bits and rerank; PQ collections train their codebook
(with OPQ, ``pq_opq_iters`` rounds) on the first synced batch and serve
from the f8 reconstruction cache with a k x 4 shortlist reranked against
the exact reconstruction.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import msgpack
import numpy as np
import torch

from coltt_tpu_torch.engine.batcher import ScanBatcher
from coltt_tpu_torch.engine.errors import EngineError, ErrorCode
from coltt_tpu_torch.engine.state import CollectionStateManager
from coltt_tpu_torch.index.bitmap import InvertedIndex
from coltt_tpu_torch.index.filter import FilterExpression, filter_from_dict
from coltt_tpu_torch.index.schema import CollectionSchema, SchemaError
from coltt_tpu_torch.ops.fused_scan import load_kernels
from coltt_tpu_torch.parallel.mesh import split
from coltt_tpu_torch.storage.objectstore import LocalObjectStore
from coltt_tpu_torch.store.flat import FlatStore
from coltt_tpu_torch.utils import trace
from coltt_tpu_torch.utils.logging import get_logger

log = get_logger("edge")

META_OBJ = "{name}.meta.json"
VERTEX_OBJ = "{name}.vertex"
INVERTED_OBJ = "{name}.inverted.raw"


@dataclass
class _EdgeCollection:
    schema: CollectionSchema
    store: FlatStore
    inverted: InvertedIndex
    metadata: Dict[int, Dict[str, Any]] = field(default_factory=dict)  # slot -> md


@dataclass
class SearchHit:
    id: str
    score: float
    metadata: Dict[str, Any]


class EdgeEngine:
    def __init__(
        self,
        object_store: LocalObjectStore,
        *,
        device="cuda",
        mesh=None,
        batch_max: int = 2048,
        batch_wait_s: float = 0.002,
        pq_opq_iters: int = 4,
        warmup_batches=(1, 8, 64),
    ):
        # multi-device serving ([serving].shards): every collection's
        # FlatStore shards its rows over this mesh
        self.mesh, self.device, self._placement = split(
            mesh if mesh is not None else device)
        # OPQ rounds of a PQ collection's training ([serving].pq_opq_iters)
        self._pq_opq_iters = int(pq_opq_iters)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {device!r} requested but torch sees no CUDA device")
            # build the fused kernel at boot, not on the first RPC
            load_kernels()
        # LoadCollection runs one search per (batch size x {default,
        # high_resource}) at k=10 before returning, so the first RPCs find
        # the kernels loaded and the allocator warm. () disables.
        self._warmup_batches = tuple(int(b) for b in (warmup_batches or ()))
        self.objects = object_store
        self.state = CollectionStateManager()
        self._collections: Dict[str, _EdgeCollection] = {}
        self._mu = threading.RLock()
        # cross-request scan coalescing (engine/batcher.py); batch_max<=1
        # disables it (every request scans alone, reference behavior)
        self._batcher = (
            ScanBatcher(max_batch=batch_max, max_wait_s=batch_wait_s)
            if batch_max > 1 else None
        )
        # LoadAuthorizationBuckets parity (edge/edge_helper.go:31-44):
        # discover existing collections from the object store at boot
        for bucket in self.objects.list_buckets():
            if self.objects.object_exists(bucket, META_OBJ.format(name=bucket)):
                self.state.add(bucket)

    # -- lifecycle -----------------------------------------------------------
    def create_collection(self, schema: CollectionSchema) -> dict:
        with self._mu:
            self.state.require_not_exists(schema.name)
            if schema.dim <= 0:
                raise EngineError("dim must be positive")
            if schema.primary_key is None:
                raise EngineError(
                    f"collection {schema.name!r} needs a string primary-key field"
                )
            col = _EdgeCollection(
                schema=schema,
                store=FlatStore(
                    schema.dim,
                    metric=schema.metric,
                    quantization=schema.quantization,
                    device=self._placement,
                    pq_opq_iters=self._pq_opq_iters,
                ),
                inverted=InvertedIndex(fields=[f.name for f in schema.fields]),
            )
            self.objects.create_bucket(schema.name, versioning=schema.versioning)
            self._collections[schema.name] = col
            self.state.add(schema.name)
            self.state.mark_loaded(schema.name)
            self._flush_objects(schema.name, col)
            log.info("created collection", extra={"kv": {"collection": schema.name}})
            return self.get_collection(schema.name)

    def delete_collection(self, name: str) -> None:
        with self._mu:
            # deleting a non-existent collection is a no-op success, like the
            # reference's idempotent drop
            self._collections.pop(name, None)
            self.objects.delete_bucket(name)
            self.state.remove(name)

    def get_collection(self, name: str) -> dict:
        self.state.require_exists(name)
        with self._mu:
            col = self._collections.get(name)
            loaded = self.state.loaded(name) and col is not None
            if col is None:
                raw = self.objects.get_object(name, META_OBJ.format(name=name))
                if raw is None:
                    raise EngineError(f"collection {name!r} metadata missing")
                schema = CollectionSchema.from_dict(json.loads(raw))
                return {
                    "schema": schema, "size": 0, "memory_bytes": 0, "loaded": False,
                }
            return {
                "schema": col.schema,
                "size": len(col.store),
                "memory_bytes": col.store.memory_bytes,
                "loaded": loaded,
            }

    def load_collection(self, name: str) -> dict:
        with self._mu:
            self.state.require_exists(name)
            if self.state.loaded(name) and name in self._collections:
                return self.get_collection(name)
            raw_meta = self.objects.get_object(name, META_OBJ.format(name=name))
            # the small objects first: no other request waits behind the
            # open vertex stream (a server may serve one body at a time)
            raw_inv = self.objects.get_object(name, INVERTED_OBJ.format(name=name))
            vertex_f = self.objects.open_object(
                name, VERTEX_OBJ.format(name=name)
            )
            if raw_meta is None or vertex_f is None or raw_inv is None:
                if vertex_f is not None:
                    vertex_f.close()
                raise EngineError(
                    f"collection {name!r} checkpoint incomplete in object store"
                )
            schema = CollectionSchema.from_dict(json.loads(raw_meta))
            # streamed read (open_object): the store decodes array by
            # array without the whole vertex body in memory
            try:
                store, metadata = self._decode_vertex_stream(vertex_f)
            finally:
                vertex_f.close()
            col = _EdgeCollection(
                schema=schema,
                store=store,
                inverted=InvertedIndex.from_bytes(raw_inv),
                metadata=metadata,
            )
            self._collections[name] = col
            self.state.mark_loaded(name)
            # version GC on load (BucketLifeCycleJob parity)
            self._gc_versions(name)
        self._warm_up(name, col)
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
        """Flush every loaded collection (edge/edge.go:46-76)."""
        with self._mu:
            for name in list(self.state.loaded_collections()):
                col = self._collections.get(name)
                if col is not None:
                    self._flush_objects(name, col)

    def _warm_up(self, name: str, col: _EdgeCollection) -> None:
        """One search per (batch size x {default, high_resource}) at k=10,
        the common serving configuration. Runs after the engine lock is
        released: the store serializes its own state."""
        if not self._warmup_batches or len(col.store) == 0:
            return
        t0 = time.perf_counter()
        for q in self._warmup_batches:
            probe = np.ones((q, col.schema.dim), np.float32)
            for hr in (False, True):
                col.store.search(probe, k=10, fused=hr,
                                 oversample=self._oversample(col))
        log.info(
            "warmed up serving shapes",
            extra={"kv": {
                "collection": name,
                "batches": list(self._warmup_batches),
                "seconds": round(time.perf_counter() - t0, 2),
            }},
        )

    # -- mutation --------------------------------------------------------------
    def index(
        self,
        name: str,
        metadata: Dict[str, Any],
        vector: Optional[np.ndarray] = None,
        *,
        delete: bool = False,
    ) -> None:
        """Insert-or-update (changed=CHANGED) or delete (changed=DELETE) a
        point, schema-validated (edge/edge.go Index + edge_analyzer.go)."""
        with self._mu:
            self.state.require_loaded(name)
            col = self._collections[name]
            try:
                if delete:
                    pk = col.schema.analyze_drop_key(metadata)
                    slot = col.store.delete(pk)
                    if slot is not None:
                        old_md = col.metadata.pop(slot, None)
                        col.inverted.remove(slot, old_md)
                    return
                md = col.schema.analyze_insert(metadata)
            except SchemaError as e:
                raise EngineError(str(e), ErrorCode.INTERNAL_FUNC_ERROR) from e
            if vector is None:
                raise EngineError("vector required for insert/update")
            pk = md[col.schema.primary_key]
            slot = col.store.upsert(pk, vector)
            old_md = col.metadata.get(slot)
            if old_md is not None:
                col.inverted.remove(slot, old_md)
            col.metadata[slot] = md
            col.inverted.add(slot, md)

    def index_many(
        self, name: str, metadatas: List[Dict[str, Any]], vectors: np.ndarray
    ) -> int:
        """Bulk ingest (no reference analogue — its gRPC path is one-by-one)."""
        with self._mu, trace.span("engine.index_many"):
            self.state.require_loaded(name)
            col = self._collections[name]
            try:
                mds = [col.schema.analyze_insert(m) for m in metadatas]
            except SchemaError as e:
                raise EngineError(str(e), ErrorCode.INTERNAL_FUNC_ERROR) from e
            pks = [m[col.schema.primary_key] for m in mds]
            slots = col.store.upsert_many(pks, vectors)
            for slot, md in zip(slots, mds):
                old_md = col.metadata.get(slot)
                if old_md is not None:
                    col.inverted.remove(slot, old_md)
                col.metadata[slot] = md
                col.inverted.add(slot, md)
            return len(slots)

    # -- search ------------------------------------------------------------------
    @staticmethod
    def _oversample(col: _EdgeCollection) -> int:
        """PQ-cache collections always rerank a k x 4 shortlist against the
        exact reconstruction (cheap; removes the cache's f8 noise)."""
        return 4 if (col.store.is_pq and col.store.pq_cache) else 1

    def _scan(self, name: str, col: _EdgeCollection, queries, k: int,
              candidates, high_resource: bool):
        """One store scan, coalesced with concurrent unfiltered searches on
        the same store when the batcher is on."""
        os_ = self._oversample(col)
        if candidates is None and self._batcher is not None:
            def scan_fn(q, kk):
                return col.store.search(q, k=kk, fused=high_resource,
                                        oversample=os_)

            return self._batcher.run(
                (name, id(col.store), bool(high_resource)), scan_fn, queries, k,
            )
        return col.store.search(queries, k=k, candidates=candidates,
                                fused=high_resource, oversample=os_)

    def _candidates(self, col: _EdgeCollection, filter_expression):
        if filter_expression is None:
            return None
        if isinstance(filter_expression, dict):
            filter_expression = filter_from_dict(filter_expression)
        return col.inverted.search(filter_expression).ids()

    def search(
        self,
        name: str,
        vector: np.ndarray,
        *,
        limit: int = 10,
        offset: int = 0,
        filter_expression: Optional[FilterExpression] = None,
        high_resource: bool = False,
    ) -> List[SearchHit]:
        """``high_resource`` (the reference's highCpu goroutine fan-out
        toggle, edge/f16_vectorstore.go:138) selects the fused scan kernel
        where the store's shape supports it. The default scan is exact."""
        with self._mu:
            self.state.require_loaded(name)
            col = self._collections[name]
        limit = max(1, int(limit))
        offset = max(0, int(offset))
        k = limit + offset
        candidates = self._candidates(col, filter_expression)

        t0 = time.monotonic_ns()
        scores, slots = self._scan(name, col, vector, k, candidates, high_resource)
        t1 = time.monotonic_ns()

        scores, slots = scores[0][offset:], slots[0][offset:]
        keep = (slots >= 0) & np.isfinite(scores)
        scores, slots = scores[keep], slots[keep]
        hits = [
            SearchHit(id=pk, score=float(score),
                      metadata=col.metadata.get(int(slot), {}))
            for pk, score, slot in zip(col.store.pks_at(slots), scores, slots)
        ]
        trace.record("engine.scan", None, t0, t1)
        trace.record("engine.flatten", None, t1, time.monotonic_ns())
        return hits

    def search_batch(
        self,
        name: str,
        vectors: np.ndarray,
        *,
        limit: int = 10,
        offset: int = 0,
        filter_expression: Optional[FilterExpression] = None,
        high_resource: bool = False,
        with_metadata: bool = False,
    ):
        """Batch-native search: one [Q, D] query block through ONE scan
        (SearchBatch RPC path).

        Returns columnar results matching the SearchBatchResponse wire
        shape: ``(counts [Q], scores flat, pks flat, metadatas flat|None)``
        — query q owns rows [sum(counts[:q]), sum(counts[:q+1])).
        """
        with self._mu:
            self.state.require_loaded(name)
            col = self._collections[name]
        queries = np.asarray(vectors, np.float32)
        if queries.ndim != 2:
            raise EngineError("search_batch wants a [Q, dim] query block")
        limit = max(1, int(limit))
        offset = max(0, int(offset))
        k = limit + offset
        candidates = self._candidates(col, filter_expression)

        t0 = time.monotonic_ns()
        scores, slots = self._scan(name, col, queries, k, candidates, high_resource)
        t1 = time.monotonic_ns()

        # columnar flatten, vectorized (row-major ravel preserves the
        # within-query descending order)
        scores = np.asarray(scores)[:, offset:]
        slots = np.asarray(slots)[:, offset:]
        keep = (slots >= 0) & np.isfinite(scores)
        counts = keep.sum(axis=1).tolist()
        flat = keep.ravel()
        out_scores = scores.ravel()[flat].tolist()
        flat_slots = slots.ravel()[flat]
        out_pks = col.store.pks_at(flat_slots)
        out_mds: Optional[List[Dict[str, Any]]] = None
        if with_metadata:
            md_of = col.metadata
            out_mds = [md_of.get(int(s), {}) for s in flat_slots]
        t2 = time.monotonic_ns()
        trace.record("engine.scan", None, t0, t1)
        trace.record("engine.flatten", None, t1, t2)
        trace.count("engine.flatten_rows", len(out_pks))
        log.debug(
            "search_batch",
            extra={"kv": {
                "collection": name, "q": queries.shape[0],
                "scan_ms": round((t1 - t0) / 1e6, 2),
                "flatten_ms": round((t2 - t1) / 1e6, 2),
            }},
        )
        return counts, out_scores, out_pks, out_mds

    # -- checkpoint objects -------------------------------------------------------
    def _flush_objects(self, name: str, col: _EdgeCollection) -> None:
        md_blob = msgpack.packb(
            [[slot, md] for slot, md in col.metadata.items()], use_bin_type=True
        )

        def write_vertex(f):
            # stream straight into the object store: metadata header, then
            # the store's row-chunked snapshot
            f.write(len(md_blob).to_bytes(8, "big"))
            f.write(md_blob)
            col.store.save(f)

        self.objects.put_object(
            name, META_OBJ.format(name=name),
            json.dumps(col.schema.to_dict()).encode(),
        )
        self.objects.put_object_stream(
            name, VERTEX_OBJ.format(name=name), write_vertex
        )
        self.objects.put_object(
            name, INVERTED_OBJ.format(name=name), col.inverted.to_bytes()
        )
        self._gc_versions(name)

    def _gc_versions(self, name: str) -> None:
        if self.objects.bucket_versioning(name):
            for obj in (META_OBJ, VERTEX_OBJ, INVERTED_OBJ):
                self.objects.cleanup_versions(name, obj.format(name=name), keep=2)

    def _decode_vertex_stream(self, f):
        md_len = int.from_bytes(f.read(8), "big")
        md_items = msgpack.unpackb(f.read(md_len), raw=False)
        metadata = {int(slot): md for slot, md in md_items}
        store = FlatStore.load(f, device=self._placement)
        return store, metadata

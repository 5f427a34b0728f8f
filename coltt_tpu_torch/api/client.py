"""gRPC clients for the three services (port of ``coltt_tpu/api/client.py``:
``EdgeClient``, ``CoreClient`` and ``ExperimentalClient``). Typed calls
over the wire surface with Pythonic helpers; channel callables are
hand-written over the generated message classes."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import grpc
import numpy as np
from google.protobuf import empty_pb2

import coltt_tpu_torch.api  # noqa: F401  (gen/ on sys.path)
import core_pb2
import edge_pb2
import experimental_pb2

from coltt_tpu_torch.api.marshal import (
    dict_to_struct,
    filter_to_proto,
    schema_to_collection_msg,
    struct_to_dict,
)
from coltt_tpu_torch.api.server import (
    _CORE_RPCS,
    _EXP_RPCS,
    EDGE_RPCS,
    _hnsw_config_to_proto,
)
from coltt_tpu_torch.index.filter import FilterExpression
from coltt_tpu_torch.index.schema import CollectionSchema
from coltt_tpu_torch.store.hnsw import HnswConfig


class _StubBase:
    SERVICE: str
    RPCS: Dict[str, Tuple[type, type]]

    def __init__(self, channel: grpc.Channel):
        self._channel = channel
        self._calls = {}
        for name, (req_cls, resp_cls) in self.RPCS.items():
            self._calls[name] = channel.unary_unary(
                f"/{self.SERVICE}/{name}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString,
            )

    def call(self, name: str, request):
        return self._calls[name](request)

    def ping(self) -> bool:
        self.call("Ping", empty_pb2.Empty())
        return True


def _raise_on_error(resp):
    if hasattr(resp, "status") and not resp.status:
        msg = "rpc failed"
        if hasattr(resp, "error") and resp.error.error_message:
            msg = resp.error.error_message
        raise RuntimeError(msg)
    return resp


class EdgeClient(_StubBase):
    RPCS = EDGE_RPCS
    SERVICE = "colttpu.edge.v1.EdgeService"

    def create_collection(self, schema: CollectionSchema):
        msg = schema_to_collection_msg(schema, edge_pb2.Collection, edge_pb2.IndexField)
        return _raise_on_error(self.call("CreateCollection", msg))

    def delete_collection(self, name: str):
        return _raise_on_error(
            self.call("DeleteCollection", edge_pb2.CollectionName(collection_name=name))
        )

    def get_collection(self, name: str):
        return _raise_on_error(
            self.call("GetCollection", edge_pb2.CollectionName(collection_name=name))
        )

    def load_collection(self, name: str):
        return _raise_on_error(
            self.call("LoadCollection", edge_pb2.CollectionName(collection_name=name))
        )

    def release_collection(self, name: str):
        return _raise_on_error(
            self.call("ReleaseCollection", edge_pb2.CollectionName(collection_name=name))
        )

    def flush(self, name: str):
        return _raise_on_error(
            self.call("Flush", edge_pb2.CollectionName(collection_name=name))
        )

    def index(
        self, name: str, primary_key: str, vector=None,
        metadata: Optional[Dict[str, Any]] = None, *, delete: bool = False,
    ):
        req = edge_pb2.IndexChange(
            collection_name=name,
            primary_key=primary_key,
            metadata=dict_to_struct(metadata or {}),
            vectors=list(map(float, vector)) if vector is not None else [],
            changed=edge_pb2.DELETE if delete else edge_pb2.CHANGED,
        )
        return _raise_on_error(self.call("Index", req))

    def bulk_index(self, name: str, primary_keys, vectors,
                   metadatas: Optional[List[Dict[str, Any]]] = None):
        """Bulk ingest: one RPC carrying a packed [N, D] float block."""
        vecs = np.ascontiguousarray(np.asarray(vectors, np.float32))
        req = edge_pb2.BulkIndexChange(
            collection_name=name,
            vectors_f32=vecs.astype("<f4", copy=False).tobytes(),
            count=vecs.shape[0],
            primary_keys=list(primary_keys),
            metadata=[dict_to_struct(m) for m in (metadatas or [])],
        )
        return _raise_on_error(self.call("BulkIndex", req))

    def search(
        self, name: str, vector, *, limit: int = 10, offset: int = 0,
        filter_expression: Optional[FilterExpression] = None,
        high_resource: bool = False,
    ) -> List[dict]:
        req = edge_pb2.SearchIndex(
            collection_name=name,
            vector=list(map(float, vector)),
            offset=offset,
            limit=limit,
            high_resource_avaliable=high_resource,
        )
        if filter_expression is not None:
            req.filter_expression.CopyFrom(filter_to_proto(filter_expression))
        resp = _raise_on_error(self.call("Search", req))
        return [
            {"id": c.id, "score": c.score, "metadata": struct_to_dict(c.metadata)}
            for c in resp.candidates
        ]

    def search_batch(
        self, name: str, vectors, *, limit: int = 10, offset: int = 0,
        filter_expression: Optional[FilterExpression] = None,
        high_resource: bool = False, include_metadata: bool = False,
    ):
        """Batch-native search: one RPC per [Q, D] query block.

        Returns ``(counts, scores, ids, metadatas)`` columnar — query q
        owns rows [sum(counts[:q]), sum(counts[:q+1])). Queries ride as
        raw f32 bytes (the fast path the server prefers)."""
        q = np.ascontiguousarray(np.asarray(vectors, np.float32))
        req = edge_pb2.SearchBatchIndex(
            collection_name=name,
            vectors_f32=q.astype("<f4", copy=False).tobytes(),
            count=q.shape[0],
            limit=limit,
            offset=offset,
            high_resource_avaliable=high_resource,
            include_metadata=include_metadata,
        )
        if filter_expression is not None:
            req.filter_expression.CopyFrom(filter_to_proto(filter_expression))
        resp = _raise_on_error(self.call("SearchBatch", req))
        mds = (
            [struct_to_dict(m) for m in resp.metadata]
            if include_metadata else None
        )
        return list(resp.counts), list(resp.scores), list(resp.ids), mds


class CoreClient(_StubBase):
    RPCS = _CORE_RPCS
    SERVICE = "colttpu.core.v1.CoreService"

    def create_collection(
        self, name: str, dim: int, *, metric: int = 0, quantization: int = 0,
        config: Optional[HnswConfig] = None,
    ):
        req = core_pb2.CollectionSpec(
            collection_name=name,
            vector_dimension=dim,
            distance=metric,
            compression_helper=quantization,
            collection_config=_hnsw_config_to_proto(config or HnswConfig()),
        )
        return _raise_on_error(self.call("CreateCollection", req))

    def drop_collection(self, name: str):
        return _raise_on_error(
            self.call("DropCollection", core_pb2.CollectionName(collection_name=name))
        )

    def collection_info(self, name: str):
        return _raise_on_error(
            self.call("CollectionInfof", core_pb2.CollectionName(collection_name=name))
        )

    def load_collection(self, name: str):
        return _raise_on_error(
            self.call("LoadCollection", core_pb2.CollectionName(collection_name=name))
        )

    def release_collection(self, name: str):
        return _raise_on_error(
            self.call("ReleaseCollection", core_pb2.CollectionName(collection_name=name))
        )

    def _change(self, name, ext_id, vector, metadata, ctype):
        return core_pb2.DatasetChange(
            id=ext_id or "",
            collection_name=name,
            vector=list(map(float, vector)) if vector is not None else [],
            metadata=dict_to_struct(metadata or {}),
            index_change_types=ctype,
        )

    def insert(self, name: str, vector, metadata=None, *, ext_id: str = ""):
        return _raise_on_error(
            self.call("Insert", self._change(name, ext_id, vector, metadata, core_pb2.INSERT))
        )

    def bulk_insert(self, name: str, vectors, metadatas=None, *, ext_ids=None):
        """Bulk ingest: one RPC carrying a packed [N, D] float block."""
        vecs = np.ascontiguousarray(np.asarray(vectors, np.float32))
        req = core_pb2.BulkDataset(
            collection_name=name,
            vectors_f32=vecs.astype("<f4", copy=False).tobytes(),
            count=vecs.shape[0],
            ids=list(ext_ids or []),
            metadata=[dict_to_struct(m) for m in (metadatas or [])],
        )
        resp = _raise_on_error(self.call("BulkInsert", req))
        return list(resp.ids)

    def update(self, name: str, ext_id: str, vector, metadata=None):
        return _raise_on_error(
            self.call("Update", self._change(name, ext_id, vector, metadata, core_pb2.UPDATE))
        )

    def delete(self, name: str, ext_id: str):
        return _raise_on_error(
            self.call("Delete", self._change(name, ext_id, None, None, core_pb2.DELETE))
        )

    def _search(self, rpc, name, vector, top_k, filters, min_score, with_latency):
        req = core_pb2.SearchRequest(
            collection_name=name,
            vector=list(map(float, vector)) if vector is not None else [],
            topK=top_k,
            min_score_threshold=min_score,
            with_latency=with_latency,
        )
        for k, v in (filters or {}).items():
            req.filter[k] = str(v)
        resp = _raise_on_error(self.call(rpc, req))
        hits = [
            {"id": c.id, "score": c.score, "metadata": struct_to_dict(c.metadata)}
            for c in resp.candidates
        ]
        return (hits, resp.latency) if with_latency else (hits, "")

    def vector_search(self, name, vector, top_k=10, *, min_score=0.0, with_latency=False):
        return self._search("VectorSearch", name, vector, top_k, None, min_score, with_latency)

    def filter_search(self, name, filters, top_k=10, *, vector=None, min_score=0.0,
                      with_latency=False):
        return self._search("FilterSearch", name, vector, top_k, filters, min_score, with_latency)

    def hybrid_search(self, name, vector, filters, top_k=10, *, min_score=0.0,
                      with_latency=False):
        return self._search("HybridSearch", name, vector, top_k, filters, min_score, with_latency)

    def vector_search_batch(
        self, name: str, vectors, top_k: int = 10, *, min_score: float = 0.0,
        include_metadata: bool = False, with_latency: bool = False,
    ):
        """Batch-native HNSW search: columnar ``(counts, scores, ids,
        metadatas, latency)`` for a [Q, D] query block in one RPC."""
        q = np.ascontiguousarray(np.asarray(vectors, np.float32))
        req = core_pb2.SearchBatchRequest(
            collection_name=name,
            vectors_f32=q.astype("<f4", copy=False).tobytes(),
            count=q.shape[0],
            topK=top_k,
            min_score_threshold=min_score,
            include_metadata=include_metadata,
            with_latency=with_latency,
        )
        resp = _raise_on_error(self.call("VectorSearchBatch", req))
        mds = (
            [struct_to_dict(m) for m in resp.metadata]
            if include_metadata else None
        )
        return (list(resp.counts), list(resp.scores), list(resp.ids), mds,
                resp.latency)

    def compare_dist(self, x, y, metric: int = 0) -> float:
        resp = self.call(
            "CompareDist",
            core_pb2.CompXyDist(
                vector_x=list(map(float, x)), vector_y=list(map(float, y)), dist=metric
            ),
        )
        return resp.score


class ExperimentalClient(_StubBase):
    RPCS = _EXP_RPCS
    SERVICE = "colttpu.experimental.v1.ExperimentalMultiVectorService"

    def _name_call(self, rpc: str, name: str):
        return _raise_on_error(
            self.call(rpc, experimental_pb2.CollectionName(collection_name=name)))

    def create_collection(self, schema: CollectionSchema):
        msg = schema_to_collection_msg(
            schema, experimental_pb2.Collection, experimental_pb2.IndexField)
        return _raise_on_error(self.call("CreateCollection", msg))

    def delete_collection(self, name: str):
        return self._name_call("DeleteCollection", name)

    def get_collection(self, name: str):
        return self._name_call("GetCollection", name)

    def load_collection(self, name: str):
        return self._name_call("LoadCollection", name)

    def release_collection(self, name: str):
        return self._name_call("ReleaseCollection", name)

    def flush(self, name: str):
        return self._name_call("Flush", name)

    def index(
        self, name: str, record_id: str,
        vectors: Optional[Dict[str, Sequence[float]]] = None,
        metadata: Optional[Dict[str, Any]] = None, *, delete: bool = False,
    ):
        req = experimental_pb2.IndexChange(
            id=record_id,
            collection_name=name,
            metadata=dict_to_struct(metadata or {}),
            changed=experimental_pb2.DELETE if delete else experimental_pb2.CHANGED,
        )
        for fname, vec in (vectors or {}).items():
            req.vectors.append(experimental_pb2.VectorIndex(
                index_name=fname, vector=list(map(float, vec))))
        return _raise_on_error(self.call("Index", req))

    def vector_search(
        self, name: str,
        query_fields: Sequence[Tuple[str, Sequence[float], bool, float]],
        top_k: int = 10, *, high_resource: bool = False,
    ) -> List[dict]:
        """CFLAT search of one query: each entry is (index_name, vector,
        include_or_not, ratio%)."""
        req = experimental_pb2.SearchMultiIndex(
            collection_name=name, topK=top_k,
            high_resource_avaliable=high_resource,
        )
        for fname, vec, include, ratio in query_fields:
            req.vector.append(experimental_pb2.MultiVectorIndex(
                index_name=fname, vector=list(map(float, vec)),
                include_or_not=include, ratio=int(ratio)))
        resp = _raise_on_error(self.call("VectorSearch", req))
        return [
            {"id": c.id, "score": c.score, "metadata": struct_to_dict(c.metadata)}
            for c in resp.candidates
        ]

    def bulk_index(
        self, name: str, record_ids: Sequence[str],
        vectors_by_field: Dict[str, Any],  # field -> [N, dim_f]
        metadatas: Optional[Sequence[Dict[str, Any]]] = None,
    ):
        """Bulk upsert: one RPC, a raw f32 block per vector field."""
        req = experimental_pb2.BulkIndexChange(
            collection_name=name, count=len(record_ids), ids=list(record_ids))
        for fname, block in vectors_by_field.items():
            b = np.ascontiguousarray(np.asarray(block, np.float32))
            req.fields.append(experimental_pb2.VectorFieldBlock(
                index_name=fname, vectors_f32=b.astype("<f4", copy=False).tobytes()))
        if metadatas is not None:
            req.metadata.extend(dict_to_struct(m) for m in metadatas)
        return _raise_on_error(self.call("BulkIndex", req))

    def vector_search_batch(
        self, name: str,
        query_fields: Sequence[Tuple[str, Any, bool, float]],
        top_k: int = 10, *, high_resource: bool = False,
        include_metadata: bool = False,
    ):
        """Batch-native CFLAT search: each entry is (index_name, [Q, D]
        query block, include_or_not, ratio%). Returns ``(counts, scores,
        ids, metadatas)`` columnar: query q owns rows [sum(counts[:q]),
        sum(counts[:q+1])). Blocks ride as raw f32 bytes."""
        req = experimental_pb2.SearchMultiIndexBatch(
            collection_name=name, topK=top_k,
            high_resource_avaliable=high_resource,
            include_metadata=include_metadata,
        )
        count = None
        for fname, block, include, ratio in query_fields:
            q = np.ascontiguousarray(np.asarray(block, np.float32))
            if q.ndim != 2:
                raise ValueError(f"field {fname!r}: query block must be [Q, D]")
            if count is None:
                count = q.shape[0]
            elif q.shape[0] != count:
                raise ValueError("all query blocks must share the same Q")
            req.vector.append(experimental_pb2.MultiVectorIndexBatch(
                index_name=fname, vectors_f32=q.astype("<f4", copy=False).tobytes(),
                include_or_not=include, ratio=int(ratio)))
        req.count = count or 0
        resp = _raise_on_error(self.call("VectorSearchBatch", req))
        mds = ([struct_to_dict(m) for m in resp.metadata]
               if include_metadata else None)
        return list(resp.counts), list(resp.scores), list(resp.ids), mds

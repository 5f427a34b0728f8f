"""gRPC servers for the three engine modes.

Port of ``coltt_tpu/api/server.py``: edge, core (``root``) and
experimental modes.
Reference parity: ``root_layer/root/rpc.go:41-137`` (keepalive params,
max message sizes, optional TLS, panic-recovery + request-logging,
graceful stop) and the 1:1 RPC->engine shims. Service handlers are
registered via gRPC generic handlers over the generated message classes.

Every RPC body is wrapped by ``_guarded`` — the recover() analogue: any
exception becomes a status=false response with the proto Error, never a
transport failure, and is logged with method + latency.
"""

from __future__ import annotations

import time
from concurrent import futures
from typing import Callable, Dict, Optional, Tuple

import grpc
import numpy as np
import torch
from google.protobuf import empty_pb2

import coltt_tpu_torch.api  # noqa: F401  (puts gen/ on sys.path)
import common_pb2
import core_pb2
import edge_pb2
import experimental_pb2

from coltt_tpu_torch.api.marshal import (
    dict_to_struct,
    error_to_proto,
    filter_from_proto,
    schema_from_collection_msg,
    schema_to_collection_msg,
    struct_to_dict,
)
from coltt_tpu_torch.engine.core import CollectionSpec, CoreEngine
from coltt_tpu_torch.engine.edge import EdgeEngine
from coltt_tpu_torch.engine.errors import EngineError
from coltt_tpu_torch.engine.experimental import ExperimentalEngine
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.store.hnsw import HEURISTIC, SIMPLE, HnswConfig
from coltt_tpu_torch.utils import trace
from coltt_tpu_torch.utils.config import Config
from coltt_tpu_torch.utils.logging import get_logger

log = get_logger("rpc")


def _guarded(fn: Callable, make_error_response: Callable, method: str):
    """recover()-parity wrapper: exceptions -> error responses, with
    per-request structured logging (interceptorLogger parity); the
    ``rpc.handler`` span's two stamps give the logged latency."""

    def wrapper(request, context):
        trace.set_method(method)
        t0 = time.monotonic_ns()
        try:
            resp = fn(request, context)
            status = "ok"
        except Exception as e:  # noqa: BLE001 — this IS the panic handler
            resp = make_error_response(e)
            status = f"error: {e}"
        t1 = time.monotonic_ns()
        trace.record("rpc.handler", method, t0, t1)
        log.info(
            fn.__qualname__,
            extra={"kv": {
                "latency_ms": round((t1 - t0) / 1e6, 3),
                "status": status,
            }},
        )
        return resp

    return wrapper


def _traced(name: str, method: str, fn: Callable) -> Callable:
    """``fn`` (a message's decode or encode) under the span ``name``."""

    def call(arg):
        with trace.span(name, method):
            return fn(arg)

    return call


class _TracedPool(futures.ThreadPoolExecutor):
    """grpc's worker pool. Each task records its wait in the queue
    (``rpc.queue``, submit to start) and its run (``rpc.call``: the wait for
    the request message, the handler, the reply's serialization and the
    start of its send) under the method of the handler that ran in it."""

    def submit(self, fn, /, *args, **kwargs):
        t_submit = time.monotonic_ns()

        def task():
            t_start = time.monotonic_ns()
            trace.set_method(None)
            try:
                return fn(*args, **kwargs)
            finally:
                t_end = time.monotonic_ns()
                method = trace.method()
                trace.record("rpc.queue", method, t_submit, t_start)
                trace.record("rpc.call", method, t_start, t_end)

        return super().submit(task)


def _vec(repeated) -> np.ndarray:
    return np.asarray(repeated, np.float32)


class EdgeServicer:
    SERVICE = "colttpu.edge.v1.EdgeService"

    def __init__(self, engine: EdgeEngine):
        self.engine = engine

    def Ping(self, request, context):
        return empty_pb2.Empty()

    def CreateCollection(self, request, context):
        schema = schema_from_collection_msg(request)
        self.engine.create_collection(schema)
        return edge_pb2.CollectionResponse(collection=request, status=True)

    def DeleteCollection(self, request, context):
        self.engine.delete_collection(request.collection_name)
        return common_pb2.Response(status=True)

    def _detail(self, name: str) -> edge_pb2.CollectionDetail:
        info = self.engine.get_collection(name)
        return edge_pb2.CollectionDetail(
            collection=schema_to_collection_msg(
                info["schema"], edge_pb2.Collection, edge_pb2.IndexField
            ),
            collection_size=info["size"],
            collection_memory=info["memory_bytes"],
            load=info["loaded"],
            status=True,
        )

    def GetCollection(self, request, context):
        return self._detail(request.collection_name)

    def LoadCollection(self, request, context):
        self.engine.load_collection(request.collection_name)
        return self._detail(request.collection_name)

    def ReleaseCollection(self, request, context):
        self.engine.release_collection(request.collection_name)
        return common_pb2.Response(status=True)

    def Flush(self, request, context):
        self.engine.flush(request.collection_name)
        return common_pb2.Response(status=True)

    def Index(self, request, context):
        name = request.collection_name
        schema = self.engine.get_collection(name)["schema"]
        pk_field = schema.primary_key
        metadata = struct_to_dict(request.metadata)
        if request.primary_key:
            metadata[pk_field] = request.primary_key
        if request.changed == edge_pb2.DELETE:
            self.engine.index(name, metadata, delete=True)
        else:
            self.engine.index(name, metadata, _vec(request.vectors))
        return common_pb2.Response(status=True)

    def BulkIndex(self, request, context):
        name = request.collection_name
        n = int(request.count)
        schema = self.engine.get_collection(name)["schema"]
        if request.vectors_f32:
            vecs = np.frombuffer(request.vectors_f32, dtype="<f4")
        else:
            vecs = np.asarray(request.vectors, np.float32)
        # validate against the schema dim, not just divisibility: an empty
        # payload passes size % n == 0 and wrong dims fail much later
        if n <= 0 or vecs.size != n * schema.dim:
            raise EngineError(
                f"vectors length {vecs.size} != count {n} * dim {schema.dim}"
            )
        vecs = vecs.reshape(n, schema.dim)
        if len(request.primary_keys) != n:
            raise EngineError("primary_keys must parallel rows")
        pk_field = schema.primary_key
        mds = [struct_to_dict(m) for m in request.metadata] or [
            {} for _ in range(n)
        ]
        if len(mds) != n:
            raise EngineError("metadata must parallel rows")
        for pk, md in zip(request.primary_keys, mds):
            md[pk_field] = pk
        self.engine.index_many(name, mds, vecs)
        return common_pb2.Response(status=True)

    def SearchBatch(self, request, context):
        name = request.collection_name
        schema = self.engine.get_collection(name)["schema"]
        if request.vectors_f32:
            # raw LE f32 bytes: zero-copy vs repeated-scalar iteration
            q = np.frombuffer(request.vectors_f32, dtype="<f4")
        else:
            q = np.asarray(request.vectors, np.float32)
        n = int(request.count)
        if n <= 0 or q.size != n * schema.dim:
            raise EngineError(
                f"vectors length {q.size} != count {n} * dim {schema.dim}"
            )
        counts, scores, pks, mds = self.engine.search_batch(
            name, q.reshape(n, schema.dim),
            limit=int(request.limit) or 10,
            offset=int(request.offset),
            filter_expression=filter_from_proto(request.filter_expression),
            high_resource=request.high_resource_avaliable,
            with_metadata=request.include_metadata,
        )
        with trace.span("rpc.reply", "SearchBatch"):
            resp = edge_pb2.SearchBatchResponse(
                status=True, counts=counts, scores=scores, ids=pks
            )
            if mds is not None:
                resp.metadata.extend(dict_to_struct(m) for m in mds)
        return resp

    def Search(self, request, context):
        hits = self.engine.search(
            request.collection_name,
            _vec(request.vector),
            limit=int(request.limit) or 10,
            offset=int(request.offset),
            filter_expression=filter_from_proto(request.filter_expression),
            high_resource=request.high_resource_avaliable,
        )
        with trace.span("rpc.reply", "Search"):
            return edge_pb2.SearchResponse(
                status=True,
                candidates=[
                    edge_pb2.Candidate(
                        metadata=dict_to_struct(h.metadata), score=h.score, id=h.id
                    )
                    for h in hits
                ],
            )


# ---------------------------------------------------------------------------
# Core
# ---------------------------------------------------------------------------

def _hnsw_config_from_proto(c: core_pb2.HnswConfig) -> HnswConfig:
    return HnswConfig(
        m=c.m or 16,
        m_max=c.m_max or None,
        m_max0=c.m_max0 or None,
        ef=c.ef or 20,
        ef_construction=c.ef_construction or 200,
        level_multiplier=c.level_multiplier or None,
        algorithm=HEURISTIC if c.search_algorithm == core_pb2.HEURISTIC else SIMPLE,
        heuristic_extend_candidates=c.heuristic_extend_candidates,
        heuristic_keep_pruned=c.heuristic_keep_pruned,
    )


def _hnsw_config_to_proto(c: HnswConfig) -> core_pb2.HnswConfig:
    c = c.resolved()
    return core_pb2.HnswConfig(
        search_algorithm=(
            core_pb2.HEURISTIC if c.algorithm == HEURISTIC else core_pb2.SIMPLE
        ),
        level_multiplier=c.level_multiplier,
        ef=c.ef,
        ef_construction=c.ef_construction,
        m=c.m,
        m_max=c.m_max,
        m_max0=c.m_max0,
        heuristic_extend_candidates=c.heuristic_extend_candidates,
        heuristic_keep_pruned=c.heuristic_keep_pruned,
    )


class CoreServicer:
    SERVICE = "colttpu.core.v1.CoreService"

    def __init__(self, engine: CoreEngine):
        self.engine = engine

    def Ping(self, request, context):
        return empty_pb2.Empty()

    def CreateCollection(self, request, context):
        spec = CollectionSpec(
            name=request.collection_name,
            dim=int(request.vector_dimension),
            metric=Metric(int(request.distance)),
            quantization=Quantization(int(request.compression_helper)),
            config=_hnsw_config_from_proto(request.collection_config),
        )
        self.engine.create_collection(spec)
        return core_pb2.CollectionResponse(status=True, spec=request)

    def DropCollection(self, request, context):
        self.engine.drop_collection(request.collection_name)
        return common_pb2.Response(status=True)

    def _msg(self, name: str) -> core_pb2.CollectionMsg:
        info = self.engine.collection_info(name)
        spec = info["spec"]
        return core_pb2.CollectionMsg(
            status=True,
            info=core_pb2.CollectionInfo(
                collection_name=spec.name,
                collection_config=_hnsw_config_to_proto(spec.config),
                vector_dimension=spec.dim,
                distance=int(spec.metric),
                compression_helper=int(spec.quantization),
                collection_size=f"{info['size']} vectors",
                collection_length=info["size"],
            ),
        )

    def CollectionInfof(self, request, context):
        return self._msg(request.collection_name)

    def LoadCollection(self, request, context):
        self.engine.load_collection(request.collection_name)
        return self._msg(request.collection_name)

    def ReleaseCollection(self, request, context):
        msg = self.engine.release_collection(request.collection_name)
        return core_pb2.ResponseWithMessage(status=True, message=msg)

    def Insert(self, request, context):
        self.engine.insert(
            request.collection_name,
            _vec(request.vector),
            struct_to_dict(request.metadata),
            ext_id=request.id or None,
        )
        return common_pb2.Response(status=True)

    def BulkInsert(self, request, context):
        count = int(request.count)
        dim = self.engine.collection_info(request.collection_name)["spec"].dim
        if request.vectors_f32:
            vecs = np.frombuffer(request.vectors_f32, dtype="<f4")
        else:
            vecs = np.asarray(request.vectors, np.float32)
        if count <= 0 or vecs.size != count * dim:
            raise ValueError(
                f"vectors length {vecs.size} != count {count} * dim {dim}"
            )
        vecs = vecs.reshape(count, dim)
        ids = self.engine.bulk_insert(
            request.collection_name,
            vecs,
            [struct_to_dict(m) for m in request.metadata] or None,
            ext_ids=list(request.ids) or None,
        )
        return core_pb2.BulkResponse(status=True, ids=ids)

    def Update(self, request, context):
        self.engine.update(
            request.collection_name,
            request.id,
            _vec(request.vector),
            struct_to_dict(request.metadata),
        )
        return common_pb2.Response(status=True)

    def Delete(self, request, context):
        self.engine.delete(request.collection_name, request.id)
        return common_pb2.Response(status=True)

    def _respond(self, hits, t0, with_latency: bool) -> core_pb2.SearchResponse:
        resp = core_pb2.SearchResponse(
            status=True,
            candidates=[
                core_pb2.Candidate(
                    id=h.id, metadata=dict_to_struct(h.metadata), score=h.score
                )
                for h in hits
            ],
        )
        if with_latency:
            # the reference declares with_latency but never populates it
            # (SURVEY.md §5); here it works
            resp.latency = f"{(time.perf_counter() - t0) * 1e3:.3f}ms"
        return resp

    def VectorSearch(self, request, context):
        t0 = time.perf_counter()
        hits = self.engine.vector_search(
            request.collection_name, _vec(request.vector),
            top_k=int(request.topK) or 10,
            min_score=request.min_score_threshold,
        )
        return self._respond(hits, t0, request.with_latency)

    def FilterSearch(self, request, context):
        t0 = time.perf_counter()
        hits = self.engine.filter_search(
            request.collection_name, dict(request.filter),
            top_k=int(request.topK) or 10,
            vector=_vec(request.vector) if request.vector else None,
            min_score=request.min_score_threshold,
        )
        return self._respond(hits, t0, request.with_latency)

    def HybridSearch(self, request, context):
        t0 = time.perf_counter()
        hits = self.engine.hybrid_search(
            request.collection_name, _vec(request.vector), dict(request.filter),
            top_k=int(request.topK) or 10,
            min_score=request.min_score_threshold,
        )
        return self._respond(hits, t0, request.with_latency)

    def VectorSearchBatch(self, request, context):
        t0 = time.perf_counter()
        name = request.collection_name
        dim = self.engine.collection_info(name)["spec"].dim
        if request.vectors_f32:
            q = np.frombuffer(request.vectors_f32, dtype="<f4")
        else:
            q = np.asarray(request.vectors, np.float32)
        n = int(request.count)
        if n <= 0 or q.size != n * dim:
            raise ValueError(
                f"vectors length {q.size} != count {n} * dim {dim}"
            )
        counts, scores, ids, mds = self.engine.vector_search_batch(
            name, q.reshape(n, dim), top_k=int(request.topK) or 10,
            min_score=request.min_score_threshold,
            with_metadata=request.include_metadata,
        )
        with trace.span("rpc.reply", "VectorSearchBatch"):
            resp = core_pb2.SearchBatchResponse(
                status=True, counts=counts, scores=scores, ids=ids
            )
            if mds is not None:
                resp.metadata.extend(dict_to_struct(m) for m in mds)
        if request.with_latency:
            resp.latency = f"{(time.perf_counter() - t0) * 1e3:.3f}ms"
        return resp

    def CompareDist(self, request, context):
        score = CoreEngine.compare_dist(
            _vec(request.vector_x), _vec(request.vector_y), Metric(int(request.dist))
        )
        return core_pb2.XyDist(score=score)


class ExperimentalServicer:
    SERVICE = "colttpu.experimental.v1.ExperimentalMultiVectorService"

    def __init__(self, engine: ExperimentalEngine):
        self.engine = engine

    def Ping(self, request, context):
        return empty_pb2.Empty()

    def CreateCollection(self, request, context):
        self.engine.create_collection(schema_from_collection_msg(request))
        return experimental_pb2.CollectionResponse(collection=request, status=True)

    def DeleteCollection(self, request, context):
        self.engine.delete_collection(request.collection_name)
        return common_pb2.Response(status=True)

    def _detail(self, name: str) -> experimental_pb2.CollectionDetail:
        info = self.engine.get_collection(name)
        return experimental_pb2.CollectionDetail(
            collection=schema_to_collection_msg(
                info["schema"], experimental_pb2.Collection,
                experimental_pb2.IndexField,
            ),
            collection_size=info["size"],
            collection_memory=info["memory_bytes"],
            load=info["loaded"],
            status=True,
        )

    def GetCollection(self, request, context):
        return self._detail(request.collection_name)

    def LoadCollection(self, request, context):
        self.engine.load_collection(request.collection_name)
        return self._detail(request.collection_name)

    def ReleaseCollection(self, request, context):
        self.engine.release_collection(request.collection_name)
        return common_pb2.Response(status=True)

    def Flush(self, request, context):
        self.engine.flush(request.collection_name)
        return common_pb2.Response(status=True)

    def Index(self, request, context):
        if request.changed == experimental_pb2.DELETE:
            self.engine.index(request.collection_name, request.id, delete=True)
        else:
            vectors = {v.index_name: _vec(v.vector) for v in request.vectors}
            self.engine.index(
                request.collection_name, request.id,
                vectors=vectors, metadata=struct_to_dict(request.metadata),
            )
        return common_pb2.Response(status=True)

    def VectorSearch(self, request, context):
        hits = self.engine.vector_search(
            request.collection_name,
            [(q.index_name, _vec(q.vector), q.include_or_not, float(q.ratio))
             for q in request.vector],
            top_k=int(request.topK) or 10,
            high_resource=request.high_resource_avaliable,
        )
        return experimental_pb2.SearchResponse(
            status=True,
            candidates=[
                experimental_pb2.Candidate(
                    id=h.id, metadata=dict_to_struct(h.metadata), score=h.score
                )
                for h in hits
            ],
        )

    @staticmethod
    def _blocks(n: int, dim: int, blocks):
        """Each field block of a bulk request as ``(field, [n, dim] f32,
        block)``; raw little-endian f32 bytes are the fast path. Checked
        against the schema dim, not just divisibility: an empty payload
        passes ``size % n == 0`` and wrong dims fail much later."""
        if n <= 0:
            raise EngineError("count must be positive")
        out = []
        for blk in blocks:
            if blk.vectors_f32:
                v = np.frombuffer(blk.vectors_f32, dtype="<f4")
            else:
                v = np.asarray(blk.vectors, np.float32)
            if v.size != n * dim:
                raise EngineError(
                    f"field {blk.index_name!r}: vectors length {v.size} != "
                    f"count {n} * dim {dim}"
                )
            out.append((blk.index_name, v.reshape(n, dim), blk))
        return out

    def BulkIndex(self, request, context):
        name = request.collection_name
        schema = self.engine.get_collection(name)["schema"]
        n = int(request.count)
        blocks = {f: v for f, v, _ in
                  self._blocks(n, schema.dim, request.fields)}
        if len(request.ids) != n:
            raise EngineError("ids must parallel rows")
        mds = [struct_to_dict(m) for m in request.metadata] or None
        if mds is not None and len(mds) != n:
            raise EngineError("metadata must parallel rows")
        self.engine.index_many(name, list(request.ids), blocks, mds)
        return common_pb2.Response(status=True)

    def VectorSearchBatch(self, request, context):
        name = request.collection_name
        schema = self.engine.get_collection(name)["schema"]
        query_fields = [
            (f, q, blk.include_or_not, float(blk.ratio))
            for f, q, blk in self._blocks(int(request.count), schema.dim,
                                          request.vector)
        ]
        counts, scores, ids, mds = self.engine.vector_search_batch(
            name, query_fields,
            top_k=int(request.topK) or 10,
            with_metadata=request.include_metadata,
        )
        resp = experimental_pb2.SearchBatchResponse(
            status=True, counts=counts, scores=scores, ids=ids
        )
        if mds is not None:
            resp.metadata.extend(dict_to_struct(m) for m in mds)
        return resp


EDGE_RPCS: Dict[str, Tuple[type, type]] = {
    "Ping": (empty_pb2.Empty, empty_pb2.Empty),
    "CreateCollection": (edge_pb2.Collection, edge_pb2.CollectionResponse),
    "DeleteCollection": (edge_pb2.CollectionName, common_pb2.Response),
    "GetCollection": (edge_pb2.CollectionName, edge_pb2.CollectionDetail),
    "LoadCollection": (edge_pb2.CollectionName, edge_pb2.CollectionDetail),
    "ReleaseCollection": (edge_pb2.CollectionName, common_pb2.Response),
    "Flush": (edge_pb2.CollectionName, common_pb2.Response),
    "Index": (edge_pb2.IndexChange, common_pb2.Response),
    "BulkIndex": (edge_pb2.BulkIndexChange, common_pb2.Response),
    "Search": (edge_pb2.SearchIndex, edge_pb2.SearchResponse),
    "SearchBatch": (edge_pb2.SearchBatchIndex, edge_pb2.SearchBatchResponse),
}

_CORE_RPCS: Dict[str, Tuple[type, type]] = {
    "Ping": (empty_pb2.Empty, empty_pb2.Empty),
    "CreateCollection": (core_pb2.CollectionSpec, core_pb2.CollectionResponse),
    "DropCollection": (core_pb2.CollectionName, common_pb2.Response),
    "CollectionInfof": (core_pb2.CollectionName, core_pb2.CollectionMsg),
    "LoadCollection": (core_pb2.CollectionName, core_pb2.CollectionMsg),
    "ReleaseCollection": (core_pb2.CollectionName, core_pb2.ResponseWithMessage),
    "Insert": (core_pb2.DatasetChange, common_pb2.Response),
    "BulkInsert": (core_pb2.BulkDataset, core_pb2.BulkResponse),
    "Update": (core_pb2.DatasetChange, common_pb2.Response),
    "Delete": (core_pb2.DatasetChange, common_pb2.Response),
    "VectorSearch": (core_pb2.SearchRequest, core_pb2.SearchResponse),
    "FilterSearch": (core_pb2.SearchRequest, core_pb2.SearchResponse),
    "HybridSearch": (core_pb2.SearchRequest, core_pb2.SearchResponse),
    "VectorSearchBatch": (
        core_pb2.SearchBatchRequest, core_pb2.SearchBatchResponse,
    ),
    "CompareDist": (core_pb2.CompXyDist, core_pb2.XyDist),
}

_EXP_RPCS: Dict[str, Tuple[type, type]] = {
    "Ping": (empty_pb2.Empty, empty_pb2.Empty),
    "CreateCollection": (
        experimental_pb2.Collection, experimental_pb2.CollectionResponse,
    ),
    "DeleteCollection": (experimental_pb2.CollectionName, common_pb2.Response),
    "GetCollection": (
        experimental_pb2.CollectionName, experimental_pb2.CollectionDetail,
    ),
    "LoadCollection": (
        experimental_pb2.CollectionName, experimental_pb2.CollectionDetail,
    ),
    "ReleaseCollection": (experimental_pb2.CollectionName, common_pb2.Response),
    "Flush": (experimental_pb2.CollectionName, common_pb2.Response),
    "Index": (experimental_pb2.IndexChange, common_pb2.Response),
    "BulkIndex": (experimental_pb2.BulkIndexChange, common_pb2.Response),
    "VectorSearch": (
        experimental_pb2.SearchMultiIndex, experimental_pb2.SearchResponse,
    ),
    "VectorSearchBatch": (
        experimental_pb2.SearchMultiIndexBatch,
        experimental_pb2.SearchBatchResponse,
    ),
}

RPC_TABLES = {
    EdgeServicer.SERVICE: EDGE_RPCS,
    CoreServicer.SERVICE: _CORE_RPCS,
    ExperimentalServicer.SERVICE: _EXP_RPCS,
}

def _error_response_factory(resp_cls):
    def make(e: Exception):
        if resp_cls is empty_pb2.Empty:
            return empty_pb2.Empty()
        resp = resp_cls()
        if hasattr(resp, "status"):
            resp.status = False
        if hasattr(resp, "error"):
            resp.error.CopyFrom(error_to_proto(e))
        return resp

    return make


def generic_handler(servicer) -> grpc.GenericRpcHandler:
    handlers = {}
    for name, (req_cls, resp_cls) in RPC_TABLES[servicer.SERVICE].items():
        fn = _guarded(getattr(servicer, name), _error_response_factory(resp_cls),
                      name)
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=_traced("rpc.decode", name, req_cls.FromString),
            response_serializer=_traced("rpc.encode", name,
                                        resp_cls.SerializeToString),
        )
    return grpc.method_handlers_generic_handler(servicer.SERVICE, handlers)


def _object_store(cfg: Config):
    """Checkpoint backend: local FS (default) or the network S3/MinIO
    client (pkg/minio parity — NewEdge dials MinIO at boot, edge/edge.go:36)."""
    if cfg.storage.object_store == "s3":
        from coltt_tpu_torch.storage.s3 import S3ObjectStore

        return S3ObjectStore(
            cfg.storage.s3_endpoint,
            cfg.storage.s3_access_key,
            cfg.storage.s3_secret_key,
            region=cfg.storage.s3_region,
            secure=cfg.storage.s3_secure,
        )
    from coltt_tpu_torch.storage.objectstore import LocalObjectStore

    return LocalObjectStore(cfg.storage.object_store_root)


def _serving_mesh(cfg: Config):
    """[serving].shards -> device mesh (None = single-device serving).
    shards=0 uses every visible CUDA device; more shards than visible CUDA
    devices raises. With ``[serving] device = "cpu"`` the mesh repeats the
    CPU device (a test deployment: the shards share the host)."""
    shards = int(cfg.serving.shards)
    if shards == 1:
        return None
    from coltt_tpu_torch.parallel.mesh import make_mesh

    device = torch.device(cfg.serving.device)
    if device.type == "cpu":
        if shards < 1:
            raise ValueError(
                '[serving].shards=0 means every CUDA device; with device = "cpu" '
                "give the shard count")
        return make_mesh(shards, devices=[device] * shards)
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if shards == 0:
        shards = n_dev
    if shards > n_dev:
        raise ValueError(
            f"[serving].shards={shards} exceeds available CUDA devices ({n_dev})")
    return make_mesh(shards) if shards > 1 else None


def build_servicer(mode: str, cfg: Config):
    """Mode dispatcher (NewRootLayer parity, root_layer/root_layer.go:30-37)."""
    if mode == "edge":
        return EdgeServicer(EdgeEngine(
            _object_store(cfg),
            device=cfg.serving.device,
            mesh=_serving_mesh(cfg),
            batch_max=cfg.serving.scan_batch_max,
            batch_wait_s=cfg.serving.scan_batch_wait_ms / 1e3,
            pq_opq_iters=cfg.serving.pq_opq_iters,
            warmup_batches=tuple(
                int(b) for b in cfg.serving.precompile_batches.split(",")
                if b.strip()
            ),
        ))
    if mode == "experimental":
        return ExperimentalServicer(ExperimentalEngine(
            _object_store(cfg), device=cfg.serving.device,
            mesh=_serving_mesh(cfg)))
    if mode in ("root", "core"):
        return CoreServicer(CoreEngine(
            cfg.storage.data_dir,
            device=cfg.serving.device,
            kv_auto_merge_interval_s=(
                cfg.storage.kv_auto_merge_interval_s or None
            ),
            kv_auto_merge_cron=cfg.storage.kv_auto_merge_cron or None,
        ))
    raise ValueError(f"unknown mode {mode!r} (want root|edge|experimental)")


def create_server(
    servicer, cfg: Optional[Config] = None, *, max_workers: Optional[int] = None
) -> grpc.Server:
    if max_workers is None:
        # worker threads mostly BLOCK in the scan batcher waiting for a
        # coalesced scan — the pool size caps how many requests can share
        # one scan, so it must exceed the wait-window's arrival count
        max_workers = max(
            64, cfg.serving.scan_batch_max // 8 if cfg else 0
        )
    cfg = cfg or Config()
    rl = cfg.root_layer
    options = [
        ("grpc.max_receive_message_length", rl.max_recv_msg_size),
        ("grpc.max_send_message_length", rl.max_send_msg_size),
        ("grpc.keepalive_time_ms", rl.keepalive_time_s * 1000),
        ("grpc.keepalive_timeout_ms", rl.keepalive_timeout_s * 1000),
        ("grpc.keepalive_permit_without_calls", 1),
        ("grpc.http2.min_recv_ping_interval_without_data_ms", 5000),
    ]
    server = grpc.server(_TracedPool(max_workers=max_workers), options=options)
    server.add_generic_rpc_handlers((generic_handler(servicer),))
    if rl.tls_pem and rl.tls_key:
        with open(rl.tls_key, "rb") as kf, open(rl.tls_pem, "rb") as cf:
            creds = grpc.ssl_server_credentials([(kf.read(), cf.read())])
        port = server.add_secure_port(rl.bind_address, creds)
    else:
        port = server.add_insecure_port(rl.bind_address)
    server.bound_port = port  # resolved port (useful with ":0" binds)
    return server

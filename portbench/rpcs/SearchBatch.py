"""Edge ``SearchBatch``: a block of queries as raw little-endian f32 bytes
(``vectors_f32``), k hits each, optionally under a filter."""

import numpy as np

import edge_pb2

from portbench.wire import filter_proto

SERVICE = "colttpu.edge.v1.EdgeService"
NAME = "SearchBatch"


def request_class():
    return edge_pb2.SearchBatchIndex


def response_class():
    return edge_pb2.SearchBatchResponse


def build(collection: str, queries: np.ndarray, traffic: dict, trace: bool):
    req = edge_pb2.SearchBatchIndex(
        collection_name=collection,
        vectors_f32=np.ascontiguousarray(queries, "<f4").tobytes(),
        count=queries.shape[0],
        limit=int(traffic["k"]),
        high_resource_avaliable=bool(traffic.get("high_resource", False)),
    )
    if traffic.get("filter"):
        req.filter_expression.CopyFrom(filter_proto(traffic["filter"]))
    return req


def decode(resp) -> dict:
    if not resp.status:
        return {"ok": False, "error": resp.error.error_message or "status false"}
    return {"ok": True, "counts": list(resp.counts), "ids": list(resp.ids),
            "scores": list(resp.scores)}

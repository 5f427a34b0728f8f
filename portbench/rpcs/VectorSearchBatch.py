"""Core ``VectorSearchBatch``: a block of queries as raw little-endian f32
bytes (``vectors_f32``), topK hits each, searched at the collection's
own ef. A hit's id is the row number (``bulk_insert``'s ``ext_ids``)."""

import numpy as np

import core_pb2

SERVICE = "colttpu.core.v1.CoreService"
NAME = "VectorSearchBatch"


def request_class():
    return core_pb2.SearchBatchRequest


def response_class():
    return core_pb2.SearchBatchResponse


def build(collection: str, queries: np.ndarray, traffic: dict, trace: bool):
    return core_pb2.SearchBatchRequest(
        collection_name=collection,
        vectors_f32=np.ascontiguousarray(queries, "<f4").tobytes(),
        count=queries.shape[0],
        topK=int(traffic["k"]),
    )


def decode(resp) -> dict:
    if not resp.status:
        return {"ok": False, "error": resp.error.error_message or "status false"}
    return {"ok": True, "counts": list(resp.counts), "ids": list(resp.ids),
            "scores": list(resp.scores)}

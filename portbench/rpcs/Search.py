"""Edge ``Search``: one query as a repeated float, k hits with their
metadata, optionally under a filter."""

import numpy as np

import edge_pb2

from portbench.wire import filter_proto

SERVICE = "colttpu.edge.v1.EdgeService"
NAME = "Search"


def request_class():
    return edge_pb2.SearchIndex


def response_class():
    return edge_pb2.SearchResponse


def build(collection: str, queries: np.ndarray, traffic: dict, trace: bool):
    if queries.shape[0] != 1:
        raise ValueError("Search carries one query: give the mix batch 1")
    req = edge_pb2.SearchIndex(
        collection_name=collection,
        vector=queries[0].tolist(),
        limit=int(traffic["k"]),
        high_resource_avaliable=bool(traffic.get("high_resource", False)),
    )
    if traffic.get("filter"):
        req.filter_expression.CopyFrom(filter_proto(traffic["filter"]))
    return req


def decode(resp) -> dict:
    if not resp.status:
        return {"ok": False, "error": resp.error.error_message or "status false"}
    hits = [(c.id, c.score, dict(c.metadata.items())) for c in resp.candidates]
    return {"ok": True, "counts": [len(hits)], "ids": [h[0] for h in hits],
            "scores": [h[1] for h in hits]}

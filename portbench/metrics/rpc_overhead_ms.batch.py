"""gRPC server layer of SearchBatch (``api/server.py`` ``EdgeServicer``,
``api/marshal.py``, grpc): the client's latency minus the servicer
method's time, mean over the requests, in ms."""

from portbench.reduce import rpc_overhead_ms


def read(rec):
    return rpc_overhead_ms(rec, "SearchBatch")

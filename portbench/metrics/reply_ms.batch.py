"""gRPC server, the reply built and serialized (``EdgeServicer.SearchBatch``
building ``SearchBatchResponse`` from the engine's columns, then
``SerializeToString``): the mean ``rpc.reply`` plus the mean ``rpc.encode``
of SearchBatch in the window, in ms a request."""

from portbench.program_spans import mean_ms


def read(rec):
    reply = mean_ms(rec, "rpc.reply", "SearchBatch")
    encode = mean_ms(rec, "rpc.encode", "SearchBatch")
    return None if reply is None or encode is None else reply + encode

"""gRPC server, the reply built and serialized (``CoreServicer.
VectorSearchBatch`` building ``SearchBatchResponse`` from the engine's
columns, then ``SerializeToString``): the mean ``rpc.reply`` plus the mean
``rpc.encode`` of VectorSearchBatch in the window, in ms a request."""

from portbench.program_spans import mean_ms


def read(rec):
    reply = mean_ms(rec, "rpc.reply", "VectorSearchBatch")
    encode = mean_ms(rec, "rpc.encode", "VectorSearchBatch")
    return None if reply is None or encode is None else reply + encode

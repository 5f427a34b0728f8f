"""gRPC server, the request decode (``api/server.py`` ``generic_handler``:
``SearchBatchIndex.FromString`` on grpc's polling thread): the mean of the
program's ``rpc.decode`` spans of SearchBatch in the window, in ms."""

from portbench.program_spans import mean_ms


def read(rec):
    return mean_ms(rec, "rpc.decode", "SearchBatch")

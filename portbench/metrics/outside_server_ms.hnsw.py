"""Client, wire and gRPC core of core VectorSearchBatch: the mean over
the answered requests of the client's latency minus the server's time for
the request (the program's ``rpc.queue`` + ``rpc.call`` of the pool task
the request ran in, matched by containment), in ms."""

from portbench.program_spans import outside_server_ms


def read(rec):
    return outside_server_ms(rec, "VectorSearchBatch")

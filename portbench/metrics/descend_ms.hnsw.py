"""HNSW upper levels (``store/hnsw.py`` ``HnswIndex.search``, the batched
greedy walk of ``_greedy_descent`` level by level): the program's
``hnsw.descend`` spans in the window over the VectorSearchBatch calls
handled there, in ms a request."""

from portbench.program_spans import per_request_ms


def read(rec):
    return per_request_ms(rec, "hnsw.descend", "VectorSearchBatch")

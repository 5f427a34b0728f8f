"""HNSW level 0 (``store/hnsw.py`` ``_beam_search_l0``, the batched
ef-bounded beam): the program's ``hnsw.beam`` spans in the window over
the VectorSearchBatch calls handled there, in ms a request."""

from portbench.program_spans import per_request_ms


def read(rec):
    return per_request_ms(rec, "hnsw.beam", "VectorSearchBatch")

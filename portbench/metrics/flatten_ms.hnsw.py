"""Core engine (``engine/core.py`` ``vector_search_batch``: the search's
distances and slots to the reply's columns, one Python step a hit): the
program's ``engine.flatten`` spans in the window over the
VectorSearchBatch calls handled there, in ms a request."""

from portbench.program_spans import per_request_ms


def read(rec):
    return per_request_ms(rec, "engine.flatten", "VectorSearchBatch")

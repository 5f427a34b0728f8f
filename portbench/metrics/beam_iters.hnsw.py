"""HNSW level 0: the beam's iterations a query block (the program's
counters ``hnsw.beam_iters`` over ``hnsw.blocks``, over every search of
the run; one block a request at the cell's size). An iteration counts
where some query of the block still expanded an entry, so at most
``max(2 * ef // expand, 8)``."""

from portbench.core_path import counter_ratio


def read(rec):
    return counter_ratio("hnsw.beam_iters", "hnsw.blocks")

"""The HNSW device search's share of its bandwidth roofline (the bytes its
work reads, counted from the program's ``hnsw.scored`` and
``hnsw.expanded`` counters by ``core_path.search_bytes``, at 3.35 TB/s,
over the device time of the kernels inside the searches of the traced
sub-window: ``hnsw.descend`` to ``hnsw.fetch``), in %."""

from portbench.core_path import roofline


def read(rec):
    return roofline(rec)

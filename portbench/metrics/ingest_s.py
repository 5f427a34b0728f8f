"""Edge engine ingest and store sync (``engine/edge.py`` ``index_many``,
``store/flat.py`` ``FlatStore.sync`` where it applied rows): the
program's spans of both that ended before the window opens, summed, in
s; part of ``setup_s``."""

from portbench.program_spans import ingest_s


def read(rec):
    return ingest_s(rec)

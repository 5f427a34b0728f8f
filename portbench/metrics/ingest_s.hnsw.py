"""Core engine ingest and commit log (``engine/core.py`` ``bulk_insert``:
the graph build, the metadata and the log batches; ``storage/kv.py``
``KV.sync``): the program's ``engine.bulk_insert`` and ``kv.sync`` spans
that ended before the window opens, summed, in s; part of ``setup_s``."""

from portbench.core_path import setup_s


def read(rec):
    return setup_s(rec, ("engine.bulk_insert", "kv.sync"))

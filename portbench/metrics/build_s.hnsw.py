"""HNSW graph build (``store/hnsw.py`` ``bulk_build_auto``: the clustered
build and one beam-refinement round, on the device): the program's
``hnsw.build`` spans that ended before the window opens, in s; part of
``ingest_s.hnsw``."""

from portbench.core_path import setup_s


def read(rec):
    return setup_s(rec, ("hnsw.build",))

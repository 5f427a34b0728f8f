"""Batcher, flat store and fused-scan wrapper (``engine/batcher.py``,
``store/flat.py``, ``ops/fused_scan.py``): the edge engine's own
``scan_ms`` of ``search_batch``, mean over its records."""

from portbench.reduce import log_mean


def read(rec):
    return log_mean(rec, "search_batch", "scan_ms")

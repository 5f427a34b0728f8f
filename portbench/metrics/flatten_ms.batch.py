"""Edge engine (``engine/edge.py`` ``search_batch``): the engine's own
``flatten_ms`` (hits to the columnar reply), mean over its records."""

from portbench.reduce import log_mean


def read(rec):
    return log_mean(rec, "search_batch", "flatten_ms")

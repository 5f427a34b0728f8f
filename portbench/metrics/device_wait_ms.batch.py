"""Flat store, the host waiting on the device's results (``store/flat.py``
around ``ops/topk.py`` ``fetch_scores_ids``: the top-k's copy to the host,
which waits for the scan): the program's ``store.fetch`` spans in the
window over the SearchBatch calls handled there, in ms a request."""

from portbench.program_spans import per_request_ms


def read(rec):
    return per_request_ms(rec, "store.fetch", "SearchBatch")

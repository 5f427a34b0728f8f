"""Batcher (``engine/batcher.py`` ``ScanBatcher.run``): the leader's wait
for followers, the program's ``batcher.wait`` spans inside the answered
Search requests summed over their number, in ms a request."""

from portbench.program_spans import batcher_wait_ms


def read(rec):
    return batcher_wait_ms(rec, "Search")

"""The device under core mode's graph search: the share of the traced
sub-window in which no kernel, copy or set ran on it (1 - the union of
the device intervals over the sub-window, ``torch.profiler``), in %."""

from portbench.reduce import idle_share


def read(rec):
    share = idle_share(rec)
    return None if share is None else 100.0 * share

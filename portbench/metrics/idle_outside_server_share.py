"""Client, wire and gRPC core as the device sees them: the share of the
traced sub-window's device-idle time (``torch.profiler``: the window less
the union of the device intervals) that no ``rpc.call`` or ``rpc.decode``
span of the program, on any thread, covers, in %."""

from portbench.program_spans import idle_outside_server_share


def read(rec):
    return idle_outside_server_share(rec)

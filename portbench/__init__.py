"""Benchmark of ``coltt_tpu_torch``: its gRPC servers driven from client
processes, one cell of ``BENCHMARK.json`` a run (``python -m
portbench.run``; see ``portbench/README.md``)."""

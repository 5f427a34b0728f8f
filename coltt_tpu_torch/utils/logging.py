"""Structured logging.

Reference parity: zerolog structured logging (``cmd/root/main.go:43-55``)
and the go-kit gRPC request-logging interceptor
(``root_layer/root/rpc.go:97-137``). Here: stdlib logging with a key=value
structured formatter; the RPC layer logs per-call method/latency/status.
"""

from __future__ import annotations

import logging
import sys
import time


class _KVFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
        base = (
            f'time={ts}.{int(record.msecs):03d}Z level={record.levelname.lower()} '
            f'component={record.name} msg="{record.getMessage()}"'
        )
        extras = getattr(record, "kv", None)
        if extras:
            base += "".join(f" {k}={v}" for k, v in extras.items())
        return base


_configured = False


def get_logger(name: str = "coltt") -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_KVFormatter())
        root = logging.getLogger("coltt")
        root.addHandler(handler)
        # COLTT_LOG_LEVEL=debug surfaces per-phase engine timings
        import os as _os

        root.setLevel(
            getattr(logging, _os.environ.get("COLTT_LOG_LEVEL", "INFO").upper(),
                    logging.INFO)
        )
        root.propagate = False
        _configured = True
    if name == "coltt" or name.startswith("coltt."):
        return logging.getLogger(name)
    return logging.getLogger(f"coltt.{name}")


def kv(**kwargs) -> dict:
    """Attach structured fields: logger.info("msg", extra=kv(a=1))."""
    return {"kv": kwargs}

"""Spans and counters of the served path, on ``time.monotonic``'s clock.

A span is a named interval ``(name, method, thread, start, end)``, stamped
with ``time.monotonic_ns`` at both ends: the clock a device trace is
aligned to and the one every process of the machine reads, so the
server's spans, its clients' latencies and the device's kernels share one
timeline. Spans go into one bounded ring per process, which overwrites its
oldest first; counters are exact totals. Both are on by default;
``configure(capacity=0)`` turns spans into no-ops and leaves counters on.

    with trace.span("engine.scan"):
        ...
    trace.record("rpc.queue", "Search", t_submit_ns, t_start_ns)
    trace.count("batcher.rows", 64)
    with trace.span("hnsw.beam", trace.method()):
        ...

:func:`set_method` names the RPC method the calling thread serves (the
gRPC handler sets it); :func:`method` reads it, so a layer below the
server can file its spans under the request's method.

Readers: :func:`spans`, :func:`oldest`, :func:`counters` and
:func:`summary` (served by ``__main__``'s ``/debug/trace``).
"""

from __future__ import annotations

import itertools
import struct
import threading
from contextlib import nullcontext
from time import monotonic_ns

import numpy as np

DEFAULT_CAPACITY = 131_072
# a slot, 40 bytes: the (name, method) pair's id, the thread, start ns, end
# ns and the slot's write number (0 before its first write)
_SLOT = struct.Struct("5q")
_PACK, _SIZE = _SLOT.pack_into, _SLOT.size
_NULL = nullcontext()
_tid = threading.get_ident


class _Span:
    __slots__ = ("_ring", "_key", "_t0")

    def __init__(self, ring: tuple, key: int):
        self._ring, self._key = ring, key

    def __enter__(self):
        self._t0 = monotonic_ns()

    def __exit__(self, et, ev, tb):
        t1 = monotonic_ns()
        buf, cap, seq = self._ring
        n = next(seq)
        _PACK(buf, (n - 1) % cap * _SIZE, self._key, _tid(), self._t0, t1, n)


class Recorder:
    """One ring of spans and one table of counters. A writer takes a slot
    with ``next()`` on a counter and fills it in one ``pack_into`` call,
    both atomic under the interpreter lock, so writers take no lock; a
    reader copies the ring in one step."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._keys: dict = {}
        self._pairs: list = []
        self._counts: dict = {}
        self.configure(capacity)

    def configure(self, capacity: int = DEFAULT_CAPACITY) -> None:
        """A new, empty ring of ``capacity`` spans; 0 records none."""
        cap = max(0, int(capacity))
        self._ring = (bytearray(_SIZE * cap), cap, itertools.count(1))

    def reset(self) -> None:
        """Drop every span and counter (the capacity stays)."""
        self.configure(self._ring[1])
        with self._lock:
            self._counts.clear()

    def _key(self, name: str, method) -> int:
        """The id of a (name, method) pair, made at its first use (the
        writers look ids up without the lock)."""
        pair = (name, method)
        with self._lock:
            if pair not in self._keys:
                self._pairs.append(pair)
                self._keys[pair] = len(self._pairs) - 1
            return self._keys[pair]

    def span(self, name: str, method: str | None = None):
        """A context manager that records the time spent inside it."""
        ring = self._ring
        if not ring[1]:
            return _NULL
        k = self._keys.get((name, method))
        return _Span(ring, self._key(name, method) if k is None else k)

    def record(self, name: str, method, t0_ns: int, t1_ns: int) -> None:
        """Record a span whose ends were stamped with ``time.monotonic_ns``."""
        buf, cap, seq = self._ring
        if cap:
            n = next(seq)
            k = self._keys.get((name, method))
            if k is None:
                k = self._key(name, method)
            _PACK(buf, (n - 1) % cap * _SIZE, k, _tid(), t0_ns, t1_ns, n)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def _held(self) -> tuple[np.ndarray, bool]:
        """The written slots, oldest write first, and whether the ring has
        overwritten any span."""
        buf, cap, _ = self._ring
        a = np.frombuffer(bytes(buf), np.int64).reshape(cap, 5)
        a = a[a[:, 4] > 0]
        a = a[np.argsort(a[:, 4], kind="stable")]
        return a, bool(len(a)) and int(a[-1, 4]) > cap

    def oldest(self):
        """The time (s, ``time.monotonic``) from which the ring holds every
        span that ended: the start of the oldest span held, or, once spans
        have been overwritten, that span's end (a span enters the ring as
        it ends, so one that ended before it may be gone). None while empty."""
        a, wrapped = self._held()
        if not len(a):
            return None
        return float(a[0, 3] if wrapped else a[:, 2].min()) / 1e9

    def spans(self, lo: float = float("-inf"), hi: float = float("inf")) -> list:
        """``(name, method, thread, start, end)`` of the spans held that
        overlap ``[lo, hi]`` (s, ``time.monotonic``), by start."""
        a, _ = self._held()
        start, end = a[:, 2] / 1e9, a[:, 3] / 1e9
        keep = np.nonzero((start <= hi) & (end >= lo))[0]
        keep = keep[np.argsort(start[keep], kind="stable")]
        pairs = self._pairs
        return [(*pairs[a[i, 0]], int(a[i, 1]), float(start[i]), float(end[i]))
                for i in keep]

    def summary(self) -> dict:
        """Per span name and method, over the ring: count, mean, p50, p95
        and max in ms; with the counters, ``oldest`` and the capacity."""
        a, _ = self._held()
        ms = (a[:, 3] - a[:, 2]) / 1e6
        rows = []
        for k in np.unique(a[:, 0]):
            d = ms[a[:, 0] == k]
            name, method = self._pairs[k]
            rows.append({
                "name": name, "method": method, "count": int(d.size),
                "mean_ms": float(d.mean()), "p50_ms": float(np.percentile(d, 50)),
                "p95_ms": float(np.percentile(d, 95)), "max_ms": float(d.max())})
        return {"spans": rows, "counters": self.counters(), "oldest": self.oldest(),
                "capacity": self._ring[1]}


_local = threading.local()


def set_method(method) -> None:
    """Name the RPC method the calling thread serves (None: none)."""
    _local.method = method


def method():
    """The RPC method the calling thread serves, or None."""
    return getattr(_local, "method", None)


_recorder = Recorder()
configure = _recorder.configure
reset = _recorder.reset
span = _recorder.span
record = _recorder.record
count = _recorder.count
counters = _recorder.counters
oldest = _recorder.oldest
spans = _recorder.spans
summary = _recorder.summary

"""What a traced run (``--trace 1``) records, from the benchmark's side.

- Spans: :meth:`Tracer.wrap` replaces a method of an object the harness
  built (a servicer, an engine, a store, an index) by one that records
  ``(name, thread, start, end, request tag)`` on ``time.monotonic``. A
  servicer method's request tag is the ``x-portbench-req`` metadata the
  clients send in a traced run.
- Log records: :meth:`Tracer.capture_log` keeps the ``kv`` fields of a
  program logger's records with a given message (the edge engine's
  ``search_batch`` debug record: ``scan_ms``, ``flatten_ms``).
- The device: :class:`DeviceTrace`, one ``torch.profiler`` session (CUDA
  activity, which holds every stream and thread of the process) from
  before the window opens to the end of its traced part, with the device
  clock aligned to ``time.monotonic`` by marker kernels.

:func:`busy_intervals` and :func:`by_name` are the reduction of
``coltt_tpu_torch/bench.py`` ``profile_round`` (the union of the device
intervals; device time summed by name), frozen here.
"""

from __future__ import annotations

import logging
import threading
import time

START_CYCLES = 1_000_000    # torch.cuda._sleep: about half a millisecond
END_CYCLES = 4_000_000      # about two milliseconds
MARK_SPLIT_NS = 1_250_000   # between the two at any clock of 1.1-2 GHz
NAME_CHARS = 120


class Tracer:
    def __init__(self):
        self.spans: list = []      # (name, thread id, start, end, tag)
        self.logs: dict = {}       # message -> [kv dict]
        self._undo: list = []

    def wrap(self, obj, attr: str, name: str, *, servicer: bool = False):
        """Record a span around every call of ``obj.attr``."""
        orig = getattr(obj, attr)
        spans = self.spans

        if servicer:
            def wrapper(request, context):
                tag = dict(context.invocation_metadata()).get("x-portbench-req")
                t0 = time.monotonic()
                try:
                    return orig(request, context)
                finally:
                    spans.append((name, threading.get_ident(), t0,
                                  time.monotonic(), tag))
        else:
            def wrapper(*args, **kwargs):
                t0 = time.monotonic()
                try:
                    return orig(*args, **kwargs)
                finally:
                    spans.append((name, threading.get_ident(), t0,
                                  time.monotonic(), None))

        return self.patch(obj, attr, wrapper)

    def patch(self, obj, attr: str, new):
        """Set ``obj.attr`` to ``new`` until :meth:`close`."""
        had = attr in vars(obj) if hasattr(obj, "__dict__") else False
        prev = getattr(obj, attr)
        setattr(obj, attr, new)
        self._undo.append((obj, attr, prev if had else None))
        return new

    def capture_log(self, logger_name: str, message: str) -> None:
        """Keep the ``kv`` of ``logger_name``'s records whose message is
        ``message``, debug records included (they are not passed on)."""
        out = self.logs.setdefault(message, [])

        class _Keep(logging.Handler):
            def emit(self, record):
                if record.getMessage() == message:
                    out.append(dict(getattr(record, "kv", {}) or {}))

        logger = logging.getLogger(logger_name)
        handler = _Keep(logging.DEBUG)
        prev = (logger.level, logger.propagate)
        logger.addHandler(handler)
        logger.setLevel(logging.DEBUG)
        logger.propagate = False
        self._undo.append((logger, handler, prev))

    def close(self) -> None:
        """Undo every wrap and log capture."""
        for obj, attr, prev in reversed(self._undo):
            if isinstance(obj, logging.Logger):
                obj.removeHandler(attr)
                obj.setLevel(prev[0])
                obj.propagate = prev[1]
            elif prev is None:
                try:
                    delattr(obj, attr)
                except AttributeError:
                    pass
            else:
                setattr(obj, attr, prev)
        self._undo = []


class DeviceTrace:
    """One ``torch.profiler`` session (CUDA activity: every stream and
    thread of the process), started before the window opens, so that the
    profiler's own start-up (seconds: CUPTI's first use) never eats into
    what it is to cover. The device clock is aligned to ``time.monotonic``
    by a marker kernel launched on a stream of its own between two host
    readings, one just after the start and a longer one just before the
    stop; a session that lost one of the two aligns on the other."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.stream = torch.cuda.Stream()
        self.marks: list = []   # (host before launch, host after completion)

    def _mark(self, cycles: int) -> None:
        torch = self.torch
        ev = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            h0 = time.monotonic()
            torch.cuda._sleep(cycles)
            ev.record(self.stream)
        ev.synchronize()
        self.marks.append((h0, time.monotonic()))

    def start(self) -> None:
        self.prof.start()
        self._mark(START_CYCLES)
        self.t_start = time.monotonic()

    def stop(self) -> None:
        self.t_end = time.monotonic()
        self._mark(END_CYCLES)
        self.prof.stop()

    def events(self, lo: float, hi: float) -> dict:
        """``{"start": lo, "end": hi, "device": [(name, start, end)]}``:
        the session's device events (kernels, copies, sets) on the host
        clock, the markers left out. Raises where the session did not
        cover ``[lo, hi]``, kept neither marker, or kept no other kernel:
        a traced run then has no device to report."""
        from torch.autograd import DeviceType

        if not (self.t_start <= lo and hi <= self.t_end):
            raise RuntimeError(
                f"the profiler covered {self.t_start:.3f}-{self.t_end:.3f}, "
                f"not the traced part {lo:.3f}-{hi:.3f}")
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns()
            raw.append((e.name(), start, start + e.duration_ns()))
        dev = align(raw, self.marks)
        if not any(is_kernel(n) and lo <= s < hi for n, s, _ in dev):
            raise RuntimeError("the profiler kept no kernel in the traced part")
        return {"start": lo, "end": hi, "device": dev}


def align(raw: list, marks: list) -> list:
    """``raw`` device events ``(name, start ns, end ns)`` on the device's
    clock as ``(name, start s, end s)`` on ``time.monotonic``, the marker
    kernels left out. ``marks`` are the host readings around the start
    marker and the end marker; each kept marker is told by its length."""
    pairs = [(r, marks[0 if r[2] - r[1] < MARK_SPLIT_NS else 1])
             for r in raw if "spin_kernel" in r[0]]
    if not pairs or len(pairs) > 2 or len({id(h) for _, h in pairs}) != len(pairs):
        raise RuntimeError(f"the profiler kept {len(pairs)} marker kernels")
    # device start - host launch and device end - host return bracket the
    # offset by a few microseconds either way
    off = sum(((r[1] - h0 * 1e9) + (r[2] - h1 * 1e9)) / 2
              for r, (h0, h1) in pairs) / len(pairs)
    return [(n[:NAME_CHARS], (s - off) / 1e9, (t - off) / 1e9)
            for n, s, t in raw if "spin_kernel" not in n]


def busy_intervals(device, lo: float, hi: float) -> list:
    """The union of the device intervals clipped to ``[lo, hi]``, as
    disjoint sorted ``(start, end)`` pairs."""
    out: list = []
    for _, s, t in sorted(device, key=lambda r: r[1]):
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def by_name(device, lo: float, hi: float) -> dict:
    """Device seconds by event name inside ``[lo, hi]``."""
    out: dict = {}
    for n, s, t in device:
        d = min(t, hi) - max(s, lo)
        if d > 0:
            out[n] = out.get(n, 0.0) + d
    return out


def is_kernel(name: str) -> bool:
    """A kernel, not a copy or a memset."""
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def label_gaps(gaps: list, spans: list) -> dict:
    """Idle seconds by what the host was doing: each gap goes to the
    innermost span that each thread was in at the gap's midpoint, the
    threads' names joined by ``+`` ("outside every span" where none)."""
    gaps = sorted(gaps, key=lambda g: (g[0] + g[1]) / 2)
    spans = sorted(spans, key=lambda s: s[2])
    stacks: dict = {}
    out: dict = {}
    i = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while i < len(spans) and spans[i][2] <= mid:
            name, tid, s, t, _ = spans[i]
            st = stacks.setdefault(tid, [])
            while st and st[-1][1] <= s:
                st.pop()
            st.append((name, t))
            i += 1
        names = set()
        for tid in list(stacks):
            st = stacks[tid]
            while st and st[-1][1] <= mid:
                st.pop()
            if st:
                names.add(st[-1][0])
            else:
                del stacks[tid]
        key = "+".join(sorted(names)) or "outside every span"
        out[key] = out.get(key, 0.0) + (b - a)
    return out

"""The readers of the program's own spans (``portbench/program_spans.py``
and the eight metrics on it), on a record made up here and a ring filled
by hand through ``coltt_tpu_torch.utils.trace``."""

import numpy as np
import pytest

from coltt_tpu_torch.utils import trace
from portbench import program_spans, spec

S = 10**9
T0, T1 = 100.0, 110.0
SENT = [100.0, 101.0, 102.0]
OK = [True, True, False]
# each request's server spans, as offsets (s) from its sent
SERVER = {
    "rpc.decode": (0.01, 0.02), "rpc.queue": (0.02, 0.03), "rpc.call": (0.03, 0.43),
    "rpc.handler": (0.05, 0.40), "batcher.wait": (0.06, 0.08),
    "store.fetch": (0.10, 0.15), "rpc.reply": (0.30, 0.35), "rpc.encode": (0.40, 0.42),
}
RPC_SPANS = ("rpc.decode", "rpc.queue", "rpc.call", "rpc.handler", "rpc.reply",
             "rpc.encode")
DEVICE = [("k1", 100.10, 100.20), ("k1", 100.40, 100.50), ("k1", 101.10, 101.15)]


def _ns(t):
    return round(t * S)


@pytest.fixture
def ring():
    trace.configure()
    yield
    trace.configure()


def _fill(rpc: str):
    """The set-up's spans, one pool task a request, and a warm-up call
    before the window that no request holds."""
    trace.record("engine.index_many", None, _ns(90.0), _ns(95.0))
    trace.record("store.sync", None, _ns(96.0), _ns(96.5))
    trace.record("rpc.call", rpc, _ns(97.0), _ns(97.5))
    for i, sent in enumerate(SENT):
        for name, (a, b) in SERVER.items():
            # the failed request's server took longer: it must not count
            b += 0.05 if not OK[i] and name == "rpc.call" else 0.0
            trace.record(name, rpc if name in RPC_SPANS else None,
                         _ns(sent + a), _ns(sent + b))
    trace.record("store.sync", None, _ns(105.0), _ns(105.1))   # inside the window


def _rec(rpc: str) -> dict:
    done = [s + 0.5 for s in SENT]
    return {"window": (T0, T1), "rpc": rpc, "spans": [], "logs": {}, "k1_calls": [],
            "requests": {"sent": np.array(SENT), "done": np.array(done),
                         "nq": np.ones(3, np.int64), "ok": np.array(OK),
                         "req": ["0.0", "0.1", "0.2"]},
            "profile": {"start": 100.0, "end": 102.0, "device": DEVICE}}


def _read(name, rec):
    return spec.load("metrics", name).read(rec)


# busy 0.25 s of 2 s; the device and the server together cover [100.01,
# 100.02], [100.03, 100.50] (a call and a kernel that outlasts it), [101.01,
# 101.02] and [101.03, 101.43]: 0.89 s. The third request starts at the
# sub-window's end.
IDLE_OUTSIDE = 100.0 * (2.0 - 0.89) / (2.0 - 0.25)

BATCH = {
    "decode_ms.batch": 10.0,
    "reply_ms.batch": 50.0 + 20.0,
    "device_wait_ms.batch": 50.0,          # three fetches over three handled calls
    "outside_server_ms.batch": 500.0 - 410.0,   # answered requests only
    "ingest_s": 5.0 + 0.5,
    "idle_outside_server_share": IDLE_OUTSIDE,
}
SEARCH = {
    "outside_server_ms.search": 90.0,
    "batcher_wait_ms.search": 20.0,        # two waits in two answered requests
    "idle_outside_server_share": IDLE_OUTSIDE,
}


@pytest.mark.parametrize("rpc, name, want", [
    *(("SearchBatch", n, v) for n, v in BATCH.items()),
    *(("Search", n, v) for n, v in SEARCH.items()),
])
def test_reader_arithmetic(ring, rpc, name, want):
    _fill(rpc)
    assert _read(name, _rec(rpc)) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", ["decode_ms.batch", "reply_ms.batch",
                                  "device_wait_ms.batch", "outside_server_ms.search",
                                  "batcher_wait_ms.search"])
def test_readers_of_the_other_rpc_find_nothing(ring, name):
    rpc = "Search" if name.endswith(".batch") else "SearchBatch"
    _fill(rpc)
    assert _read(name, _rec(rpc)) is None


def test_idle_is_intersected_not_labelled_by_midpoint(ring):
    """A gap whose midpoint lies inside a call counts only its part outside."""
    trace.record("rpc.call", "Search", _ns(100.0), _ns(100.6))
    rec = _rec("Search")
    rec["profile"] = {"start": 100.0, "end": 101.0, "device": [("k", 100.9, 101.0)]}
    # idle [100, 100.9]; the call covers [100, 100.6]: 0.3 s of 0.9 outside
    assert _read("idle_outside_server_share", rec) == pytest.approx(100 * 0.3 / 0.9)


@pytest.mark.parametrize("name", [*BATCH, *SEARCH])
def test_none_where_the_ring_no_longer_holds_the_part_read(ring, name):
    rpc = "Search" if name in SEARCH else "SearchBatch"
    trace.configure(capacity=8)
    _fill(rpc)
    assert trace.oldest() > T0
    assert _read(name, _rec(rpc)) is None


@pytest.mark.parametrize("name", [*BATCH, *SEARCH])
def test_none_without_the_program_ring(ring, monkeypatch, name):
    rpc = "Search" if name in SEARCH else "SearchBatch"
    _fill(rpc)
    monkeypatch.setattr(program_spans, "_ring", lambda: None)
    assert _read(name, _rec(rpc)) is None


def test_none_without_spans_or_profile(ring):
    rec = _rec("SearchBatch")
    trace.record("engine.scan", None, _ns(99.0), _ns(99.1))
    assert trace.oldest() < T0
    assert all(_read(n, rec) is None for n in BATCH)
    _fill("SearchBatch")
    rec["profile"] = None
    assert _read("idle_outside_server_share", rec) is None

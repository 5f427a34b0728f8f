"""Reductions the per-layer readers in ``portbench/metrics`` share.

A reader gets the traced run's record:

- ``window``: ``(t0, t1)`` on ``time.monotonic``;
- ``requests``: the clients' records, arrays ``sent``, ``done``, ``nq``,
  ``ok`` and the list ``req`` of request tags;
- ``spans``: ``(name, thread, start, end, tag)`` of the wrapped calls
  (``rpc.<RPC>`` with the request's tag, ``engine.<method>``,
  ``batcher.run``, ``store.search``);
- ``logs``: the program's captured log fields by message;
- ``k1_calls``: ``(time, Qp, N, D, code dtype)`` of each K1 launch;
- ``profile``: None without a device trace, else ``start`` / ``end`` of
  the traced sub-window and ``device``: ``(name, start, end)`` of each
  device event on the host clock;
- ``rpc``: the mix's RPC.

A reader returns None where it finds nothing to read.
"""

from __future__ import annotations

import numpy as np

from portbench.trace import busy_intervals


def rpc_overhead_ms(rec: dict, rpc: str):
    """Mean over the answered requests of the client's latency minus the
    time spent in the servicer's method, matched by request tag."""
    if rec["rpc"] != rpc:
        return None
    inside = {tag: t - s for name, _, s, t, tag in rec["spans"]
              if name == f"rpc.{rpc}" and tag}
    r = rec["requests"]
    diffs = [(done - sent) - inside[tag]
             for tag, sent, done, ok in zip(r["req"], r["sent"], r["done"], r["ok"])
             if ok and tag in inside]
    return 1e3 * float(np.mean(diffs)) if diffs else None


def log_mean(rec: dict, message: str, key: str):
    vals = [float(kv[key]) for kv in rec["logs"].get(message, []) if key in kv]
    return float(np.mean(vals)) if vals else None


def profile_window(rec: dict):
    """``(device events, lo, hi)`` of the traced sub-window, or None."""
    p = rec.get("profile")
    if not p or not p["device"]:
        return None
    return p["device"], p["start"], p["end"]


def idle_share(rec: dict):
    w = profile_window(rec)
    if w is None:
        return None
    dev, lo, hi = w
    busy = sum(b - a for a, b in busy_intervals(dev, lo, hi))
    return 1.0 - busy / (hi - lo)

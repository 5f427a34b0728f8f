"""Cross-request scan batching: coalesce concurrent searches into one scan.

A scan reads the whole corpus whatever the query count, so one 2048-query
scan moves about the same device-memory traffic as a 1-query scan, and
serving throughput under concurrent load comes from batching *across*
RPCs, not from running many 1-query scans side by side. The reference has
no equivalent (its goroutine model runs one full scan per request,
edge/edge.go:610). Port of ``coltt_tpu/engine/batcher.py``, without the
power-of-two padding of each scan chunk (eager PyTorch compiles nothing).

Mechanics: requests for the same (collection, scan-parameter) group enqueue
under a lock; the first waiter becomes the *leader*, waits up to
``max_wait_s`` for followers (returning early when ``max_batch`` query rows
accumulate), then runs ONE stacked scan and distributes row slices.
Followers block on an event. Worst-case added latency is ``max_wait_s``
(default 2 ms — small against a 1M-row scan, invisible under load because
a full batch departs immediately). A submission may carry a whole [q, D]
query block (the SearchBatch RPC path) — blocks and single vectors
coalesce together. Filtered searches (per-request candidate sets) do not
batch — they take the direct path in the engine.

Pipelining: the leader holds no lock while the device scan runs, so the
next group forms behind it and its leader dispatches concurrently — under
sustained load the device pipeline stays full (group N+1's scan is queued
while group N's results are in flight back to the host).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np

from coltt_tpu_torch.utils import trace


@dataclass
class _Pending:
    vectors: np.ndarray         # [q, D] — one or many query rows
    k: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Tuple[np.ndarray, np.ndarray]] = None
    error: Optional[BaseException] = None


class ScanBatcher:
    """Groups concurrent scan requests by key and runs one scan per group.

    ``scan_fn(queries [Q, D], k) -> (scores [Q, >=k], ids [Q, >=k])`` is
    supplied per call (it closes over the store and scan params); the key
    must change whenever scan_fn's behavior would (collection identity,
    quantization epoch, approx/fused flags, metric).
    """

    def __init__(self, max_batch: int = 2048, max_wait_s: float = 0.002):
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._lock = threading.Lock()
        self._queues: Dict[Hashable, List[_Pending]] = {}
        self._rows: Dict[Hashable, int] = {}

    def run(
        self,
        key: Hashable,
        scan_fn: Callable[[np.ndarray, int], Tuple[np.ndarray, np.ndarray]],
        vectors: np.ndarray,
        k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Submit query rows (``[D]`` or ``[q, D]``); returns their
        ``(scores [q, k], ids [q, k])`` slice of the coalesced scan."""
        arr = np.asarray(vectors, np.float32)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        me = _Pending(vectors=arr, k=int(k))
        with self._lock:
            queue = self._queues.setdefault(key, [])
            queue.append(me)
            self._rows[key] = self._rows.get(key, 0) + arr.shape[0]
            leader = len(queue) == 1

        if not leader:
            me.done.wait()
            if me.error is not None:
                raise me.error
            return me.result

        # leader: give followers a short window to pile in (skip the wait
        # when this submission alone already fills the batch)
        if arr.shape[0] < self.max_batch:
            t_wait = time.monotonic_ns()
            deadline = time.monotonic() + self.max_wait_s
            while True:
                with self._lock:
                    if self._rows[key] >= self.max_batch:
                        break
                now = time.monotonic()
                if now >= deadline:
                    break
                time.sleep(min(deadline - now, 0.0002))
            trace.record("batcher.wait", None, t_wait, time.monotonic_ns())

        with self._lock:
            batch = self._queues.pop(key)
            self._queues[key] = []
            self._rows[key] = 0
            # anything enqueued after this point starts a new group
        try:
            queries = (
                batch[0].vectors if len(batch) == 1
                else np.concatenate([p.vectors for p in batch])
            )
            kk = max(p.k for p in batch)
            n = queries.shape[0]
            # run in chunks of <= max_batch rows: bounds the scan's [Q, *]
            # transients
            out_s: List[np.ndarray] = []
            out_i: List[np.ndarray] = []
            for start in range(0, n, self.max_batch):
                chunk = queries[start:start + self.max_batch]
                s, i = scan_fn(chunk, kk)
                out_s.append(np.asarray(s))
                out_i.append(np.asarray(i))
            scores = out_s[0] if len(out_s) == 1 else np.concatenate(out_s)
            ids = out_i[0] if len(out_i) == 1 else np.concatenate(out_i)
            row = 0
            for p in batch:
                q = p.vectors.shape[0]
                p.result = (scores[row:row + q, : p.k], ids[row:row + q, : p.k])
                row += q
        except BaseException as e:  # noqa: BLE001 — fan the failure out
            for p in batch:
                p.error = e
            raise
        finally:
            with self._lock:
                if not self._queues.get(key):
                    self._queues.pop(key, None)
                    self._rows.pop(key, None)
            # how many scans coalescing saved, process-wide
            trace.count("batcher.groups")
            trace.count("batcher.requests", len(batch))
            trace.count("batcher.rows", sum(p.vectors.shape[0] for p in batch))
            for p in batch:
                if p is not batch[0]:
                    p.done.set()
        return batch[0].result

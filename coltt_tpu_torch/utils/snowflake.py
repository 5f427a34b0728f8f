"""Snowflake id generator.

Reference parity: ``pkg/snowflake/snowflake.go:116-182`` (vendored
bwmarrin/snowflake: 41-bit ms timestamp since a custom epoch, 10-bit node,
12-bit step, monotonic within a millisecond) and the core id generator that
wraps node 0 and maps ids to uint64 (``core/core_gen_id.go:22-40``).

A copy of ``coltt_tpu/utils/snowflake.py`` (importing that package would
load JAX).
"""

from __future__ import annotations

import threading
import time

# bwmarrin default epoch: 2010-11-04 01:42:54.657 UTC (in ms)
_EPOCH_MS = 1288834974657

_NODE_BITS = 10
_STEP_BITS = 12
_NODE_MAX = (1 << _NODE_BITS) - 1
_STEP_MASK = (1 << _STEP_BITS) - 1
_TIME_SHIFT = _NODE_BITS + _STEP_BITS
_NODE_SHIFT = _STEP_BITS


class SnowflakeNode:
    def __init__(self, node: int = 0):
        if not 0 <= node <= _NODE_MAX:
            raise ValueError(f"node id must be in [0, {_NODE_MAX}]")
        self._node = node
        self._mu = threading.Lock()
        self._time = 0
        self._step = 0

    def generate(self) -> int:
        """Next unique id (always positive; fits in uint64)."""
        with self._mu:
            now = int(time.time() * 1000) - _EPOCH_MS
            if now == self._time:
                self._step = (self._step + 1) & _STEP_MASK
                if self._step == 0:
                    while now <= self._time:
                        now = int(time.time() * 1000) - _EPOCH_MS
            else:
                self._step = 0
            self._time = now
            return (now << _TIME_SHIFT) | (self._node << _NODE_SHIFT) | self._step

    @staticmethod
    def parse(sid: int) -> dict:
        return {
            "timestamp_ms": (sid >> _TIME_SHIFT) + _EPOCH_MS,
            "node": (sid >> _NODE_SHIFT) & _NODE_MAX,
            "step": sid & _STEP_MASK,
        }

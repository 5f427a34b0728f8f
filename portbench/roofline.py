"""Peaks of the card and the work of a kernel, frozen from
``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``PEAK_OPS_PER_S``, ``bound``).

The published dense peaks of one NVIDIA H100 SXM at its full 700 W limit;
a run reports the card's power limit beside any share of them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}

K1_CHUNKS = (2048, 4096)   # K1 keeps one survivor per chunk // 128 rows
K1_LANES = 128


def k1_chunk(n: int) -> int:
    """The chunk K1 scans ``n`` code rows in: 4096 where ``n`` allows."""
    return 4096 if n % 4096 == 0 else 2048


def k1_int8_work(qp: int, n: int, d: int) -> tuple[float, float]:
    """``(operations, bytes)`` of one launch of K1's int8 loop: 2*Qp*N*D
    multiply-adds counted as two operations; bytes read once (int8
    queries and codes, the f32 row factors ``rowmul`` / ``rowadd``) and
    written once (the ``[Qp, N / chunk * 128]`` int32 keys)."""
    ops = 2.0 * qp * n * d
    keys = qp * (n // k1_chunk(n)) * K1_LANES * 4
    moved = qp * d + n * d + 2 * 4 * n + keys
    return ops, float(moved)


def k1_int8_bound_s(qp: int, n: int, d: int) -> float:
    """The least time of that launch: the larger of its operations at the
    int8 peak and its bytes at the memory rate."""
    ops, moved = k1_int8_work(qp, n, d)
    return max(ops / PEAK_OPS_PER_S["int8"], moved / HBM_BYTES_PER_S)

"""ctypes bindings for the native IO library (native/colttio.cpp).

Port of ``coltt_tpu/native.py``. The native layer covers host-side hot
loops of the commit log: WAL chunk framing, record replay and CRC32
(``pkg/wal/segment.go`` roles); it has no device code. The Python
implementations in :mod:`coltt_tpu_torch.storage.wal` remain as the
portable fallback, bit-identical on disk: set ``COLTT_NATIVE=0`` to force
them.

The shared library is built on first use with ``g++`` (one ``-O3 -shared``
translation unit) from the repository's ``native/colttio.cpp`` into
``native/build/libcolttio.so``, the same source and file the JAX package
uses. The build writes a temporary file and renames it into place, so two
processes that build at once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "colttio.cpp")
_SO = os.path.join(_NATIVE_DIR, "build", "libcolttio.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

# reusable scan buffers (see wal_scan)
_scan_arena: Optional[np.ndarray] = None
_scan_recs: Optional[np.ndarray] = None


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-Wall", "-fPIC", "-shared", "-std=c++17",
             "-o", tmp, _SRC, "-lz"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("COLTT_NATIVE", "1") == "0":
            return None
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.cio_crc32.argtypes = [u8p, i64]
        lib.cio_crc32.restype = ctypes.c_uint32
        lib.cio_wal_frame.argtypes = [u8p, i64, i64, u8p, i64]
        lib.cio_wal_frame.restype = i64
        lib.cio_wal_frame_batch.argtypes = [u8p, i64p, i64, i64, u8p, i64, i64p]
        lib.cio_wal_frame_batch.restype = i64
        lib.cio_wal_decode.argtypes = [u8p, i64, i64, u8p, i64]
        lib.cio_wal_decode.restype = i64
        lib.cio_wal_scan.argtypes = [u8p, i64, u8p, i64, i64p, i64, i64p]
        lib.cio_wal_scan.restype = i64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def describe() -> str:
    """Which path the commit log's framing and replay take in this
    process: the native library (with its path) or the Python loops."""
    if os.environ.get("COLTT_NATIVE", "1") == "0":
        return "python (COLTT_NATIVE=0)"
    return f"native ({_SO})" if available() else "python (native build failed)"


def _u8(buf) -> ctypes.POINTER(ctypes.c_uint8):
    """Zero-copy uint8 pointer to a bytes/bytearray/ndarray buffer."""
    if isinstance(buf, (bytes, bytearray)):
        buf = np.frombuffer(buf, np.uint8)  # read-only view, no copy
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def crc32(data: bytes) -> int:
    lib = _load()
    assert lib is not None
    return int(lib.cio_crc32(_u8(data), len(data)))


def _framed_cap(n: int) -> int:
    # per fragment: 7-byte header + <=6 bytes of block-tail padding
    frags = 2 + n // (32 * 1024 - 7)
    return n + 13 * frags + 16


def wal_frame(payload: bytes, offset: int) -> Optional[bytes]:
    """Frame one payload for appending at absolute segment ``offset``.
    Returns the framed bytes (with any leading block padding)."""
    lib = _load()
    if lib is None:
        return None
    n = len(payload)
    cap = _framed_cap(n)
    out = np.empty(cap, np.uint8)
    w = lib.cio_wal_frame(
        _u8(payload), n, offset,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    if w < 0:
        return None
    return out[:w].tobytes()


def wal_frame_batch(payloads, offset: int) -> Optional[Tuple[bytes, np.ndarray]]:
    """Frame many payloads in one call, appending at ``offset``.

    Returns ``(framed_bytes, positions)`` where positions is int64
    [count, 3] rows of (start_block, start_off, total_size)."""
    lib = _load()
    if lib is None:
        return None
    joined = b"".join(payloads)
    lens = np.array([len(p) for p in payloads], np.int64)
    cap = int(sum(_framed_cap(int(n)) for n in lens)) + 16
    out = np.empty(cap, np.uint8)
    pos = np.empty((len(payloads), 3), np.int64)
    w = lib.cio_wal_frame_batch(
        _u8(joined), lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(payloads), offset,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if w < 0:
        return None
    return out[:w].tobytes(), pos


def wal_decode(raw: bytes, abs_off: int) -> Optional[bytes]:
    """Reassemble one record's payload from its on-disk chunk bytes."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(len(raw), np.uint8)
    w = lib.cio_wal_decode(
        _u8(raw), len(raw), abs_off,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out),
    )
    if w < 0:
        raise ValueError("corrupt WAL chunk (native decode)")
    return out[:w].tobytes()


def wal_scan(segment: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Replay a whole segment buffer.

    Returns ``(arena, recs)``: ``arena`` uint8 payload bytes, ``recs``
    int64 [count, 5] rows of (payload_off, payload_len, block_number,
    chunk_offset, chunk_size). None if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(segment)
    # Reuse cached buffers: fresh multi-MB allocations fault in new pages
    # on every call (mmap'd and munmap'd by the allocator), which is the
    # dominant cost on throttled hosts. The returned arrays are views into
    # these caches — consume them before the next wal_scan call.
    global _scan_arena, _scan_recs
    if _scan_arena is None or len(_scan_arena) < n:
        _scan_arena = np.empty(max(n, 1 << 20), np.uint8)
    used = ctypes.c_int64(0)
    # records are usually >=64 B; retry with a bigger table on -2
    max_recs = max(n // 64 + 16, 16)
    while True:
        if _scan_recs is None or len(_scan_recs) < max_recs:
            _scan_recs = np.empty((max(max_recs, 1 << 14), 5), np.int64)
        count = lib.cio_wal_scan(
            _u8(segment), n,
            _scan_arena.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(_scan_arena),
            _scan_recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(_scan_recs),
            ctypes.byref(used),
        )
        if count == -2 and max_recs < n:  # recs table too small
            max_recs = len(_scan_recs) * 4
            _scan_recs = None
            continue
        break
    if count < 0:
        return None
    return _scan_arena[: used.value], _scan_recs[:count]

"""Segmented append-only write-ahead log.

Reference parity: ``pkg/wal`` — 32 KB blocks, 7-byte chunk headers
(CRC32 + length + type), chunk types FULL/FIRST/MIDDLE/LAST for payloads
spanning blocks (segment.go:47-60), segment rotation at SegmentSize,
pending-writes batch API, positional reads by
``ChunkPosition{SegmentId, BlockNumber, ChunkOffset, ChunkSize}``
(segment.go:96-110), full-log readers (wal.go:190-296).

Port of ``coltt_tpu/storage/wal.py``: the same on-disk format, so a log
written by either package replays in the other. The framing / replay /
CRC hot loops run in the native library (native/colttio.cpp via
:mod:`coltt_tpu_torch.native`) when it is available, with this module's
Python loops as the bit-identical fallback (``COLTT_NATIVE=0`` forces
them). The WAL backs the KV commit log that makes device-side mutations
crash-safe: a write is acknowledged only after it is in the log, so
un-checkpointed device state can always be replayed.

One departure from the reference: a closed segment leaves the deferred
fsync set only after its fsync succeeds (``sync_closed``), so a failed
fsync is retried by the next ``sync()`` instead of being forgotten.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from coltt_tpu_torch import native

BLOCK_SIZE = 32 * 1024
CHUNK_HEADER_SIZE = 7  # crc32(4) + length(2) + type(1)

CHUNK_FULL = 0
CHUNK_FIRST = 1
CHUNK_MIDDLE = 2
CHUNK_LAST = 3

_SEG_EXT = ".seg"


class CorruptLogError(Exception):
    pass


@dataclass(frozen=True)
class ChunkPosition:
    segment_id: int
    block_number: int
    chunk_offset: int
    chunk_size: int  # total bytes on disk incl. headers, all fragments

    def pack(self) -> bytes:
        return struct.pack(
            ">IIII", self.segment_id, self.block_number, self.chunk_offset,
            self.chunk_size,
        )

    @classmethod
    def unpack(cls, b: bytes) -> "ChunkPosition":
        return cls(*struct.unpack(">IIII", b[:16]))


def _segment_path(directory: str, seg_id: int) -> str:
    return os.path.join(directory, f"{seg_id:010d}{_SEG_EXT}")


class WAL:
    """One writer, many positional readers."""

    def __init__(
        self,
        directory: str,
        *,
        segment_size: int = 1 << 30,
        sync_on_write: bool = False,
    ):
        self.directory = directory
        self.segment_size = segment_size
        self.sync_on_write = sync_on_write
        os.makedirs(directory, exist_ok=True)

        seg_ids = sorted(
            int(fn[: -len(_SEG_EXT)])
            for fn in os.listdir(directory)
            if fn.endswith(_SEG_EXT)
        )
        self._segment_ids: List[int] = seg_ids or [0]
        self._active_id = self._segment_ids[-1]
        path = _segment_path(directory, self._active_id)
        self._active = open(path, "ab+")
        self._active.seek(0, os.SEEK_END)
        self._write_off = self._active.tell()
        # segments closed by _rotate without an fsync (buffered mode); sync()
        # must flush these too or a post-rotation sync() leaves whole closed
        # segments non-durable while callers (write_hint) believe they are
        self._unsynced_closed: List[str] = []

    # -- write ---------------------------------------------------------------
    def _rotate(self) -> None:
        self._active.flush()
        if self.sync_on_write:
            # durability at rotation only when the WAL promises per-write
            # durability anyway; in buffered mode the contract is explicit
            # sync() points, and this fsync measured ~100 ms under the
            # write lock on a busy disk — the KV merge test's residual
            # writer stall after sub-batching
            os.fsync(self._active.fileno())
        else:
            # deferred: the next sync() fsyncs this closed segment so the
            # explicit-durability contract covers records written before
            # the rotation
            self._unsynced_closed.append(
                _segment_path(self.directory, self._active_id))
        self._active.close()
        self._active_id += 1
        self._segment_ids.append(self._active_id)
        self._active = open(_segment_path(self.directory, self._active_id), "ab+")
        self._write_off = 0

    def write(self, data: bytes) -> ChunkPosition:
        return self.write_batch([data])[0]

    @staticmethod
    def _est_framed(n: int) -> int:
        """Upper bound on framed size: 7-byte header + <=6 pad per fragment."""
        frags = 2 + n // (BLOCK_SIZE - CHUNK_HEADER_SIZE)
        return n + 13 * frags

    def write_batch(self, datas: List[bytes]) -> List[ChunkPosition]:
        """Append all payloads, rotating segments as needed; one framing
        pass + flush per segment-group (single native call when available).

        Empty payloads are rejected: an empty FULL chunk's header
        (crc=0, len=0, type=0) is indistinguishable from block padding on
        replay."""
        for d in datas:
            if not d:
                raise ValueError("empty WAL payloads are not allowed")
        positions: List[ChunkPosition] = []
        idx = 0
        while idx < len(datas):
            base = self._write_off
            # rotate first if the next payload can't start in this segment
            if base > 0 and base + self._est_framed(len(datas[idx])) > self.segment_size:
                self._rotate()
                base = 0
            # group consecutive payloads that fit the current segment
            group: List[bytes] = []
            acc = 0
            while idx < len(datas):
                est = self._est_framed(len(datas[idx]))
                if group and base + acc + est > self.segment_size:
                    break
                group.append(datas[idx])
                acc += est
                idx += 1
            buf, pos = self._frame_group(group, base)
            self._active.write(buf)
            self._active.flush()
            if self.sync_on_write:
                os.fsync(self._active.fileno())
            self._write_off = self._active.tell()
            positions.extend(
                ChunkPosition(self._active_id, int(b), int(o), int(t))
                for b, o, t in pos
            )
        return positions

    def _frame_group(self, group: List[bytes], base: int):
        """Frame a group of payloads starting at segment offset ``base``.
        Returns (framed bytes, [(start_block, start_off, total), ...])."""
        if native.available():
            framed = native.wal_frame_batch(group, base)
            if framed is not None:
                return framed[0], framed[1].tolist()
        buf = bytearray()
        pos = []
        for payload in group:
            off = base + len(buf)
            remaining = payload
            first = True
            while True:
                cur_off = (base + len(buf)) % BLOCK_SIZE
                room = BLOCK_SIZE - cur_off
                if room < CHUNK_HEADER_SIZE:
                    buf.extend(b"\x00" * room)  # pad to block boundary
                    continue
                space = room - CHUNK_HEADER_SIZE
                frag = remaining[:space]
                remaining = remaining[len(frag):]
                if first and not remaining:
                    ctype = CHUNK_FULL
                elif first:
                    ctype = CHUNK_FIRST
                elif remaining:
                    ctype = CHUNK_MIDDLE
                else:
                    ctype = CHUNK_LAST
                header = struct.pack(">IHB", zlib.crc32(frag), len(frag), ctype)
                buf.extend(header)
                buf.extend(frag)
                first = False
                if not remaining:
                    break
            pos.append((off // BLOCK_SIZE, off % BLOCK_SIZE, base + len(buf) - off))
        return bytes(buf), pos

    def sync_closed(self) -> None:
        """fsync segments closed by rotation since the last sync. Safe to
        call without the owner's write lock (list ops are GIL-atomic):
        callers that hold a lock across sync() can drain the (possibly
        many, post-merge) closed-segment fsyncs OUTSIDE it first, so the
        locked sync() touches at most the active segment.

        A path leaves the deferred set only once its fsync has succeeded
        (or the segment is gone): an fsync that raises leaves it there, and
        the next sync() tries it again. The reference pops it first and so
        drops a failed segment's durability silently."""
        while self._unsynced_closed:
            path = self._unsynced_closed[-1]
            try:
                with open(path, "rb") as f:
                    os.fsync(f.fileno())
            except FileNotFoundError:
                pass  # segment retired by a merge — its data moved elsewhere
            try:
                self._unsynced_closed.remove(path)
            except ValueError:
                pass  # a concurrent sync_closed or detach took it first

    def sync(self) -> None:
        # closed-but-unsynced segments first: a crash after sync() must not
        # lose records the caller was told are durable just because a
        # rotation happened since the last sync
        self.sync_closed()
        self._active.flush()
        os.fsync(self._active.fileno())

    def close(self) -> None:
        self.sync()
        self._active.close()

    # -- read ------------------------------------------------------------------
    def read(self, pos: ChunkPosition) -> bytes:
        path = _segment_path(self.directory, pos.segment_id)
        abs_off = pos.block_number * BLOCK_SIZE + pos.chunk_offset
        with open(path, "rb") as f:
            f.seek(abs_off)
            raw = f.read(pos.chunk_size)
        if native.available():
            try:
                return native.wal_decode(raw, abs_off)
            except ValueError as e:
                raise CorruptLogError(f"{e} at {pos}") from None
        return self._decode_chunks(raw, pos)

    @staticmethod
    def _decode_chunks(raw: bytes, pos) -> bytes:
        out = bytearray()
        i = 0
        abs_off = pos.block_number * BLOCK_SIZE + pos.chunk_offset
        while i < len(raw):
            cur = (abs_off + i) % BLOCK_SIZE
            room = BLOCK_SIZE - cur
            if room < CHUNK_HEADER_SIZE:
                i += room  # block padding
                continue
            crc, length, ctype = struct.unpack(">IHB", raw[i : i + CHUNK_HEADER_SIZE])
            frag = raw[i + CHUNK_HEADER_SIZE : i + CHUNK_HEADER_SIZE + length]
            if zlib.crc32(frag) != crc:
                raise CorruptLogError(f"crc mismatch at {pos}")
            out.extend(frag)
            i += CHUNK_HEADER_SIZE + length
            if ctype in (CHUNK_FULL, CHUNK_LAST):
                break
        return bytes(out)

    def read_all(self) -> Iterator[Tuple[bytes, ChunkPosition]]:
        """Replay every payload in log order (index rebuild path)."""
        yield from self._iter_segments(self._segment_ids)

    def read_from(self, start_segment: int, start_offset: int
                  ) -> Iterator[Tuple[bytes, ChunkPosition]]:
        """Replay only payloads at/after ``(start_segment, start_offset)``
        — the hint-file fast-reopen path: segments before the boundary are
        never opened; the boundary segment is scanned but records below the
        absolute byte offset are dropped."""
        segs = [s for s in self._segment_ids if s >= start_segment]
        for payload, pos in self._iter_segments(segs):
            if (pos.segment_id == start_segment
                    and pos.block_number * BLOCK_SIZE + pos.chunk_offset
                    < start_offset):
                continue
            yield payload, pos

    def _iter_segments(self, seg_ids) -> Iterator[Tuple[bytes, ChunkPosition]]:
        for seg_id in seg_ids:
            path = _segment_path(self.directory, seg_id)
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                data = f.read()
            if native.available():
                scanned = native.wal_scan(data)
                if scanned is not None:
                    arena, recs = scanned
                    # materialize before yielding: the arena is a shared
                    # cache that the next wal_scan call overwrites
                    items = [
                        (
                            arena[p_off : p_off + p_len].tobytes(),
                            ChunkPosition(seg_id, blk, c_off, c_size),
                        )
                        for p_off, p_len, blk, c_off, c_size in recs.tolist()
                    ]
                    yield from items
                    continue
            i = 0
            pending = bytearray()
            start: Optional[Tuple[int, int]] = None
            while i + CHUNK_HEADER_SIZE <= len(data):
                cur = i % BLOCK_SIZE
                room = BLOCK_SIZE - cur
                if room < CHUNK_HEADER_SIZE:
                    i += room
                    continue
                crc, length, ctype = struct.unpack(
                    ">IHB", data[i : i + CHUNK_HEADER_SIZE]
                )
                if crc == 0 and length == 0 and ctype == 0:
                    # zero padding / preallocated tail — skip to next block
                    i += room
                    continue
                frag = data[i + CHUNK_HEADER_SIZE : i + CHUNK_HEADER_SIZE + length]
                if len(frag) < length or zlib.crc32(frag) != crc:
                    # torn tail write — stop replay of this segment
                    break
                if ctype in (CHUNK_FULL, CHUNK_FIRST):
                    pending = bytearray(frag)
                    start = (i // BLOCK_SIZE, i % BLOCK_SIZE)
                else:
                    pending.extend(frag)
                i += CHUNK_HEADER_SIZE + length
                if ctype in (CHUNK_FULL, CHUNK_LAST) and start is not None:
                    pos = ChunkPosition(
                        seg_id, start[0], start[1],
                        i - (start[0] * BLOCK_SIZE + start[1]),
                    )
                    yield bytes(pending), pos
                    pending = bytearray()
                    start = None

    # -- maintenance -------------------------------------------------------------
    def segments(self) -> List[int]:
        return list(self._segment_ids)

    def remove_segments(self, seg_ids: List[int]) -> None:
        """Drop obsolete segments after compaction (diskv merge swap)."""
        for path in self.detach_segments(seg_ids):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass

    def detach_segments(self, seg_ids: List[int]) -> List[str]:
        """De-register segments and return their file paths WITHOUT
        deleting — the caller unlinks them outside any lock (file
        deletion under the KV write lock showed up as a ~175 ms writer
        stall at the end of a 100k-record merge)."""
        paths = []
        for sid in seg_ids:
            if sid == self._active_id:
                continue
            if sid in self._segment_ids:
                self._segment_ids.remove(sid)
            path = _segment_path(self.directory, sid)
            # a segment about to be unlinked never needs its deferred fsync
            # (its live records were rewritten elsewhere) — dropping it here
            # keeps sync() from paying journal commits for dead files
            try:
                self._unsynced_closed.remove(path)
            except ValueError:
                pass
            paths.append(path)
        return paths

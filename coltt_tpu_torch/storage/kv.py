"""Bitcask-style key-value store on the WAL (the core commit log).

Reference parity: ``diskv/`` — Open with directory lock + index build
(db.go:71-147,497+), Put/Get/Delete/Exist each wrapping a single-op Batch
(db.go:245-300), batches with ids and a batch-finish marker record
(batch.go:115-344), ordered iteration (db.go:309-469), Merge compaction
rewriting live records with a hint file for fast index rebuild
(merge.go:40-330, hint write :180-221), cron-scheduled auto-merge
(options.go:55-62 + merge.go:239-330 — here a plain interval thread), and
buffered async Watch events (watch.go:25-119 — a ring that drops oldest on
overflow, dispatched OFF the write path). Record format: type + batch_id +
expire + key/value lengths + payload, CRC at the WAL chunk layer
(record.go:42-130); record expiry (record.go:52-57, checked on read
db.go:470-495 and dropped by merge merge.go:138) is honored via per-key
TTLs.

Port of ``coltt_tpu/storage/kv.py``: the same data, hint and merge
records, so a directory written by either package opens in the other.

The in-memory index is a dict (key -> position) plus a blocked sorted key
list (:mod:`coltt_tpu_torch.utils.sortedkeys` — the role of diskv's
google/btree): ordered ops are O(log n + m) with no resort cliff.
Compaction is **non-blocking** like the reference's merge-directory scheme
(merge.go:40-221): the write lock is held only to snapshot the key list,
per ~1k-record rewrite chunk, and for the final segment retire — writers
proceed between chunks. Where diskv restores time-order by renaming the
merge directory's segments below the live ones, this log is single-
sequence, so merge rewrites instead carry their record's ORIGINAL batch id
(REC_MERGE_PUT) and replay resolves every key by max batch id — a
concurrent overwrite beats an interleaved merge copy regardless of
physical log order; live readers are protected by a position re-check
before each index update. Reopen loads the newest HINT snapshot (written
on merge and on clean close) and replays only WAL records past the hint
boundary — a compacted 1M-record log reopens without touching the payload
segments.
"""

from __future__ import annotations

import collections
import fcntl
import os
import struct
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

from coltt_tpu_torch.storage.wal import WAL, ChunkPosition
from coltt_tpu_torch.utils import trace
from coltt_tpu_torch.utils.sortedkeys import SortedKeys

REC_PUT = 1
REC_DELETE = 2
REC_BATCH_FINISH = 3
# compaction rewrite carrying the ORIGINAL record's batch id (no finish
# marker — each is a self-contained CRC-checked copy of a committed
# record). Additive to format "2": only this build reads these dirs.
REC_MERGE_PUT = 4

_LOCK_FILE = "FLOCK"
_FORMAT_FILE = "FORMAT"
_FORMAT = "2"  # record header v2 (adds the expire stamp)
_HINT_FILE = "HINT"
_HINT_MAGIC = b"CTTHINT1"

_HDR = struct.Struct(">BQqII")  # type, batch_id, expire (unix ns, 0=never)
# hint entries: expire + ChunkPosition + key length (key bytes follow)
_HINT_ENT = struct.Struct(">qIIIII")


def _encode_record(rtype: int, batch_id: int, key: bytes, value: bytes,
                   expire: int = 0) -> bytes:
    return _HDR.pack(rtype, batch_id, expire, len(key), len(value)) + key + value


def _decode_record(b: bytes) -> Tuple[int, int, bytes, bytes, int]:
    rtype, batch_id, expire, klen, vlen = _HDR.unpack(b[: _HDR.size])
    key = b[_HDR.size : _HDR.size + klen]
    value = b[_HDR.size + klen : _HDR.size + klen + vlen]
    return rtype, batch_id, key, value, expire


class _Entry(NamedTuple):
    pos: ChunkPosition
    expire: int  # unix ns; 0 = never

    def live(self, now: Optional[int] = None) -> bool:
        return self.expire == 0 or self.expire > (now or time.time_ns())


class Batch:
    """Atomic multi-op write: records + finish marker hit the log together;
    the index is updated only after the finish marker is durable."""

    def __init__(self, db: "KV", batch_id: int):
        self._db = db
        self._id = batch_id
        self._pending: Dict[bytes, Tuple[Optional[bytes], int]] = {}

    def put(self, key: bytes, value: bytes, *, ttl: Optional[float] = None) -> None:
        expire = time.time_ns() + int(ttl * 1e9) if ttl is not None else 0
        self._pending[bytes(key)] = (bytes(value), expire)

    def delete(self, key: bytes) -> None:
        self._pending[bytes(key)] = (None, 0)

    def get(self, key: bytes) -> Optional[bytes]:
        key = bytes(key)
        if key in self._pending:
            value, expire = self._pending[key]
            if expire and expire <= time.time_ns():
                return None
            return value
        return self._db.get(key)

    def rollback(self) -> None:
        """Discard pending writes (batch.go:345 — nothing hit the log yet)."""
        self._pending = {}

    def commit(self) -> None:
        """Write the batch to the log (the span ``kv.commit``)."""
        if not self._pending:
            return
        db = self._db
        with db._mu, trace.span("kv.commit"):
            payloads = []
            keys = []
            for key, (value, expire) in self._pending.items():
                if value is None:
                    payloads.append(_encode_record(REC_DELETE, self._id, key, b""))
                else:
                    payloads.append(
                        _encode_record(REC_PUT, self._id, key, value, expire)
                    )
                keys.append((key, value, expire))
            payloads.append(_encode_record(REC_BATCH_FINISH, self._id, b"", b""))
            positions = db._wal.write_batch(payloads)
            for (key, value, expire), pos in zip(keys, positions[:-1]):
                if value is None:
                    if db._index.pop(key, None) is not None:
                        db._sorted.discard(key)
                    db._emit("delete", key, None)
                else:
                    if key not in db._index:
                        db._sorted.add(key)
                    db._index[key] = _Entry(pos, expire)
                    db._emit("put", key, value)
            db._writes_since_merge += len(keys)
        self._pending = {}


class KV:
    """Single-process KV with crash-safe replay."""

    def __init__(self, directory: str, *, segment_size: int = 1 << 30,
                 sync_on_write: bool = False,
                 auto_merge_interval_s: Optional[float] = None,
                 auto_merge_cron: Optional[str] = None,
                 watch_buffer: int = 8192):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self._lock_f = open(os.path.join(directory, _LOCK_FILE), "w")
        try:
            fcntl.flock(self._lock_f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            raise RuntimeError(f"data dir {directory} is locked by another process") from e
        try:
            # record-format guard: decoding a v1 (pre-expire, 17-byte header)
            # log with the v2 layout would corrupt the index silently
            fmt_path = os.path.join(directory, _FORMAT_FILE)
            wal_dir = os.path.join(directory, "wal")
            has_data = os.path.isdir(wal_dir) and any(os.scandir(wal_dir))
            if os.path.exists(fmt_path):
                with open(fmt_path) as f:
                    found = f.read().strip()
                if found != _FORMAT:
                    raise RuntimeError(
                        f"KV dir {directory} uses record format {found!r}; "
                        f"this build reads format {_FORMAT!r}"
                    )
            elif has_data:
                raise RuntimeError(
                    f"KV dir {directory} predates the record-format marker "
                    "(v1 headers); it cannot be read by this build"
                )
            else:
                with open(fmt_path, "w") as f:
                    f.write(_FORMAT)
            self._wal = WAL(
                wal_dir,
                segment_size=segment_size,
                sync_on_write=sync_on_write,
            )
            self._mu = threading.RLock()
            self._merge_mu = threading.Lock()  # one compaction at a time
            self._index: Dict[bytes, _Entry] = {}
            self._sorted = SortedKeys()
            self._batch_seq = 0
            self._watchers: List[Callable[[str, bytes, Optional[bytes]], None]] = []
            # async watch dispatch (watch.go buffered queue): a bounded ring
            # drained by one daemon thread, so a slow watcher never stalls
            # writers (events drop oldest on overflow, like the Go ring)
            self._events: collections.deque = collections.deque(
                maxlen=max(1, int(watch_buffer))
            )
            self._events_cv = threading.Condition()
            self._stop = threading.Event()
            self._dispatcher: Optional[threading.Thread] = None
            self._merger: Optional[threading.Thread] = None
            self._writes_since_merge = 0
            self.replayed_records = 0  # observability: hint effectiveness
            self._replay()
            self._auto_merge_interval_s = auto_merge_interval_s
            # cron-spec scheduling (diskv options.go:55-62 AutoMergeCronExpr
            # via robfig/cron): parse eagerly so a bad spec fails at open
            if auto_merge_cron:
                from coltt_tpu_torch.utils.cron import CronSchedule
                self._merge_cron = CronSchedule(auto_merge_cron)
            else:
                self._merge_cron = None
            if auto_merge_interval_s or self._merge_cron:
                self._merger = threading.Thread(
                    target=self._auto_merge_loop, daemon=True,
                    name="kv-auto-merge",
                )
                self._merger.start()
        except BaseException:
            # a failed open must not keep the directory flock'd — a caller
            # catching the error and retrying (or a non-refcounting runtime)
            # would otherwise deadlock against our own stale lock
            fcntl.flock(self._lock_f, fcntl.LOCK_UN)
            self._lock_f.close()
            raise

    # -- hint snapshot (diskv merge.go:180-221 hint files) ---------------------
    def write_hint(self) -> None:
        """Snapshot the in-memory index + WAL boundary so the next open
        replays only records past the boundary. Written on merge() and on
        clean close(); atomic via tmp+rename."""
        # drain closed-segment fsyncs (many after a merge's rotations)
        # before taking the write lock, so the locked sync() below fsyncs
        # at most the active segment — bounded writer stall
        self._wal.sync_closed()
        with self._mu:
            self._wal.sync()
            boundary_seg = self._wal._active_id
            boundary_off = self._wal._write_off
            seq = self._batch_seq
            items = list(self._index.items())
        parts = [
            _HINT_MAGIC,
            struct.pack(">IQQQ", boundary_seg, boundary_off, seq, len(items)),
        ]
        for key, ent in items:
            p = ent.pos
            parts.append(_HINT_ENT.pack(
                ent.expire, p.segment_id, p.block_number, p.chunk_offset,
                p.chunk_size, len(key),
            ))
            parts.append(key)
        path = os.path.join(self.directory, _HINT_FILE)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(b"".join(parts))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _load_hint(self) -> Optional[Tuple[int, int]]:
        """Load the HINT snapshot into the index; returns the replay
        boundary ``(segment_id, abs_offset)`` or None (full replay). A hint
        referencing segments the WAL no longer has (e.g. a crash between a
        later merge's segment swap and its hint write) is discarded."""
        path = os.path.join(self.directory, _HINT_FILE)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                data = f.read()
            if data[: len(_HINT_MAGIC)] != _HINT_MAGIC:
                return None
            off = len(_HINT_MAGIC)
            bseg, boff, seq, count = struct.unpack_from(">IQQQ", data, off)
            off += struct.calcsize(">IQQQ")
            live = set(self._wal.segments())
            if bseg not in live:
                return None
            index: Dict[bytes, _Entry] = {}
            now = time.time_ns()
            for _ in range(count):
                expire, seg, blk, coff, csz, klen = _HINT_ENT.unpack_from(
                    data, off
                )
                off += _HINT_ENT.size
                key = data[off: off + klen]
                off += klen
                if seg not in live:
                    return None  # stale hint: payload segment is gone
                if expire == 0 or expire > now:
                    index[key] = _Entry(
                        ChunkPosition(seg, blk, coff, csz), expire
                    )
        except (struct.error, IndexError, OSError):
            return None
        self._index = index
        self._batch_seq = max(self._batch_seq, seq)
        return bseg, boff

    # -- startup replay (diskv loadIndexFromWAL, db.go:497) -------------------
    def _replay(self) -> None:
        boundary = self._load_hint()
        now = time.time_ns()
        staged: Dict[int, List[Tuple[int, bytes, ChunkPosition, int]]] = {}
        # per-key resolution is by MAX batch id, not log order: a merge
        # rewrite (REC_MERGE_PUT, carrying its record's original id) may be
        # physically interleaved after a concurrent overwrite it must lose to
        applied: Dict[bytes, int] = {}

        def apply(rtype: int, bid: int, key: bytes, pos: ChunkPosition,
                  expire: int) -> None:
            if bid < applied.get(key, -1):
                return
            applied[key] = bid
            if rtype != REC_DELETE and (expire == 0 or expire > now):
                self._index[key] = _Entry(pos, expire)
            else:
                self._index.pop(key, None)

        records = (
            self._wal.read_from(*boundary) if boundary is not None
            else self._wal.read_all()
        )
        for payload, pos in records:
            self.replayed_records += 1
            rtype, batch_id, key, _, expire = _decode_record(payload)
            if rtype == REC_BATCH_FINISH:
                for r, k, p, e in staged.pop(batch_id, []):
                    apply(r, batch_id, k, p, e)
                self._batch_seq = max(self._batch_seq, batch_id)
            elif rtype == REC_MERGE_PUT:
                # self-contained committed copy: applies without a finish
                # marker. Still bumps the sequence — after the original
                # segments are retired, the carried ids are the only trace
                # of how high the sequence got, and fresh writes must not
                # reuse (and thus lose to) them.
                apply(rtype, batch_id, key, pos, expire)
                self._batch_seq = max(self._batch_seq, batch_id)
            else:
                staged.setdefault(batch_id, []).append((rtype, key, pos, expire))
        # unfinished batches (crash mid-commit) are discarded — atomicity
        self._sorted = SortedKeys(self._index.keys())

    # -- single-op API (each wraps a Batch, db.go:245-300) --------------------
    def new_batch(self) -> Batch:
        with self._mu:
            self._batch_seq += 1
            return Batch(self, self._batch_seq)

    def put(self, key: bytes, value: bytes, *, ttl: Optional[float] = None) -> None:
        b = self.new_batch()
        b.put(key, value, ttl=ttl)
        b.commit()

    def delete(self, key: bytes) -> None:
        b = self.new_batch()
        b.delete(key)
        b.commit()

    def get(self, key: bytes) -> Optional[bytes]:
        key = bytes(key)
        for attempt in range(2):
            with self._mu:
                ent = self._index.get(key)
            if ent is None or not ent.live():
                return None
            try:
                payload = self._wal.read(ent.pos)
            except (FileNotFoundError, OSError):
                if attempt == 0:
                    # a concurrent merge retired this segment between our
                    # index lookup and the read; the index already points at
                    # the rewrite (updates land before segments go) — retry
                    continue
                raise
            _, _, _, value, _ = _decode_record(payload)
            return value
        return None  # unreachable; keeps type checkers honest

    def ttl(self, key: bytes) -> Optional[float]:
        """Seconds until expiry; None if missing/expired; inf if no TTL."""
        with self._mu:
            ent = self._index.get(bytes(key))
        if ent is None or not ent.live():
            return None
        if ent.expire == 0:
            return float("inf")
        return (ent.expire - time.time_ns()) / 1e9

    def exists(self, key: bytes) -> bool:
        with self._mu:
            ent = self._index.get(bytes(key))
        return ent is not None and ent.live()

    def __len__(self) -> int:
        now = time.time_ns()
        with self._mu:
            return sum(1 for e in self._index.values() if e.live(now))

    def stat(self) -> Dict[str, int]:
        """Live key count + on-disk bytes (db.go:230 Stat)."""
        disk = sum(
            os.path.getsize(os.path.join(root, f))
            for root, _, files in os.walk(self.directory)
            for f in files
        )
        return {"keys": len(self), "disk_size": disk,
                "segments": len(self._wal.segments())}

    # -- ordered iteration (db.go:309-469; btree role -> SortedKeys) -----------
    def _keys_sorted(self) -> List[bytes]:
        """Full ordered snapshot — O(n) copy, never a resort."""
        with self._mu:
            return list(self._sorted)

    def ascend(self, *, start: Optional[bytes] = None, end: Optional[bytes] = None
               ) -> Iterator[Tuple[bytes, bytes]]:
        with self._mu:
            ks = self._sorted.range_list(start, end)  # O(log n + m) snapshot
        for k in ks:
            v = self.get(k)
            if v is not None:
                yield k, v

    def descend(self) -> Iterator[Tuple[bytes, bytes]]:
        for k in reversed(self._keys_sorted()):
            v = self.get(k)
            if v is not None:
                yield k, v

    @staticmethod
    def _prefix_end(prefix: bytes) -> Optional[bytes]:
        """Smallest upper bound covering every key with ``prefix``: the
        prefix with its last non-0xff byte incremented (None = unbounded)."""
        p = bytearray(prefix)
        while p and p[-1] == 0xFF:
            p.pop()
        if not p:
            return None
        p[-1] += 1
        return bytes(p)

    def keys(self, prefix: bytes = b"", *, filter_expired: bool = True
             ) -> List[bytes]:
        with self._mu:
            if prefix:
                end = self._prefix_end(prefix)
                ks = self._sorted.range_list(start=prefix, end=end)
                # range_list's end bound is inclusive and the bound itself
                # never carries the prefix — drop an exact match
                if ks and end is not None and ks[-1] == end:
                    ks.pop()
            else:
                ks = list(self._sorted)
            if filter_expired:
                now = time.time_ns()
                idx = self._index
                ks = [k for k in ks if k in idx and idx[k].live(now)]
        return ks

    # -- watch (watch.go buffered event queue) ---------------------------------
    def watch(self, fn: Callable[[str, bytes, Optional[bytes]], None]) -> None:
        """Register a watcher. Events are dispatched from a dedicated
        thread (never inside the write lock): a slow watcher delays other
        watchers' delivery, not writers. The buffer is a bounded ring that
        drops the oldest event on overflow (watch.go:25-119 semantics)."""
        with self._mu:
            self._watchers.append(fn)
            if self._dispatcher is None:
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, daemon=True, name="kv-watch"
                )
                self._dispatcher.start()

    def unwatch(self, fn: Callable) -> None:
        with self._mu:
            if fn in self._watchers:
                self._watchers.remove(fn)

    def _emit(self, event: str, key: bytes, value: Optional[bytes]) -> None:
        # O(1) enqueue under the write lock; delivery happens elsewhere
        if not self._watchers:
            return
        with self._events_cv:
            self._events.append((event, key, value))
            self._events_cv.notify()

    def _dispatch_loop(self) -> None:
        while True:
            with self._events_cv:
                while not self._events and not self._stop.is_set():
                    self._events_cv.wait(0.1)
                if not self._events:
                    if self._stop.is_set():
                        return
                    continue
                ev = self._events.popleft()
            for fn in list(self._watchers):
                try:
                    fn(*ev)
                except Exception:
                    pass

    # -- compaction (diskv merge.go) ---------------------------------------------
    _MERGE_CHUNK = 1024  # snapshot/read granularity (outside the lock)
    _WRITE_SUB = 64      # records appended per lock hold (bounds writer stall)

    def merge(self) -> None:
        """Non-blocking compaction: rewrite live records into fresh
        segments while writers proceed, then drop the old ones.

        Matches the reference's concurrent merge (merge.go:40-221 rewrites
        into a merge-directory DB while the main DB serves, then swaps
        segments). Here the lock is held only to (a) rotate + snapshot the
        key list, (b) append one ~64-record sub-batch (a single buffered
        WAL append — bounded µs, vs the r03 shape that held the lock
        across a 1k-record chunk's disk I/O and stalled writers ~1 s),
        and (c) retire the old segments. Correctness against concurrent
        writers:

        - rotation freezes everything below ``boundary``; values are read
          back OUTSIDE the lock from those immutable segments;
        - each index update is position-checked (``index[k] is ent``) so an
          overwrite or delete that landed mid-merge wins in memory;
        - rewrites carry their record's ORIGINAL batch id (REC_MERGE_PUT),
          so replay resolves interleavings by max batch id (see _replay);
        - expired records are dropped (merge.go:138), including their index
          entries, so no entry outlives its retired segment;
        - readers racing the final retire re-check the index (get() retry).
        """
        if not self._merge_mu.acquire(blocking=False):
            return  # compaction already running (auto-merge + manual overlap)
        try:
            with self._mu:
                old_segments = self._wal.segments()
                self._wal._rotate()
                boundary = self._wal._active_id
                snapshot = list(self._sorted)

            for i in range(0, len(snapshot), self._MERGE_CHUNK):
                chunk = snapshot[i:i + self._MERGE_CHUNK]
                with self._mu:
                    now = time.time_ns()
                    rewrite: List[Tuple[bytes, _Entry]] = []
                    for k in chunk:
                        ent = self._index.get(k)
                        if ent is None or ent.pos.segment_id >= boundary:
                            continue  # deleted / rewritten by a concurrent writer
                        if not ent.live(now):
                            del self._index[k]
                            self._sorted.discard(k)
                            continue
                        rewrite.append((k, ent))
                if not rewrite:
                    continue
                # read the frozen segments without the lock
                datas = []
                for k, ent in rewrite:
                    _, obid, _, value, expire = _decode_record(
                        self._wal.read(ent.pos)
                    )
                    datas.append(
                        (k, ent, expire,
                         _encode_record(REC_MERGE_PUT, obid, k, value, expire))
                    )
                # append in small sub-batches so a concurrent writer waits
                # behind at most ONE ~64-record buffered append (µs), never
                # a full 1k-record chunk with its disk I/O — the r03 shape
                # stalled writers ~1 s behind a 100k-record merge
                for j in range(0, len(datas), self._WRITE_SUB):
                    sub = datas[j:j + self._WRITE_SUB]
                    with self._mu:
                        positions = self._wal.write_batch([d[3] for d in sub])
                        for (k, ent, expire, _), pos in zip(sub, positions):
                            if self._index.get(k) is ent:  # unchanged since pass 1
                                self._index[k] = _Entry(pos, expire)
                    # yield the GIL so a blocked writer actually gets the
                    # lock: without this the releasing thread re-acquires
                    # before the waiter is scheduled (lock convoy — the
                    # sub-batching alone still showed >100 ms stalls)
                    time.sleep(0)
                # fsync rewrite segments as they rotate closed (outside the
                # lock), so the final write_hint's durability drain is at
                # most one segment instead of a burst of journal commits
                self._wal.sync_closed()

            with self._mu:
                # every index entry now points at segments >= boundary (the
                # chunk loop rewrote or dropped everything below it, and
                # concurrent writers only ever append above it), so the old
                # files can be unlinked outside the lock; in-flight readers
                # are covered by the get() retry
                dead = self._wal.detach_segments(
                    [s for s in old_segments if s < boundary]
                )
                self._writes_since_merge = 0
            for p in dead:
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
            # hint AFTER the segment swap so a crash in between leaves a
            # stale hint that _load_hint discards (full replay, still safe)
            self.write_hint()
        finally:
            self._merge_mu.release()

    def _auto_merge_loop(self) -> None:
        """Scheduled compaction (diskv options.go:55-62 AutoMergeCronExpr /
        merge.go:239-330): a cron spec (utils/cron.py, same 5-field dialect
        as robfig/cron) or a plain interval."""
        while True:
            if self._merge_cron is not None:
                delay = self._merge_cron.seconds_until_next(time.time())
            else:
                delay = self._auto_merge_interval_s
            if self._stop.wait(delay):
                return
            if self._writes_since_merge:
                try:
                    self.merge()
                except Exception:
                    pass  # next tick retries; merge failures must not kill the thread

    def sync(self) -> None:
        """Make every committed batch durable (the span ``kv.sync``)."""
        with trace.span("kv.sync"):
            self._wal.sync()

    def close(self) -> None:
        self._stop.set()
        with self._events_cv:
            self._events_cv.notify_all()
        for t in (self._dispatcher, self._merger):
            if t is not None:
                t.join(timeout=5.0)
        self.write_hint()  # clean close -> next open skips the full replay
        self._wal.close()
        fcntl.flock(self._lock_f, fcntl.LOCK_UN)
        self._lock_f.close()

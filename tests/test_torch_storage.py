"""Core storage of both packages: WAL, KV commit log, object store, the
native IO library, cron specs and the sorted key index.

The cases of ``test_storage.py``, ``test_native.py``, ``test_cron.py`` and
``test_sortedkeys.py`` run against the JAX package and its port through the
``pkg`` fixture; then logs and KV directories written by either package
are opened by the other, the port's deferred-fsync fix is held, and the
non-blocking merge is held by counting the writes that finish while it
runs (no bound on the clock).
"""

import datetime as dt
import errno
import fcntl
import importlib
import os
import random
import struct
import threading
import time
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ("coltt_tpu", "coltt_tpu_torch")


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{name}") for name in (
        "native", "storage.wal", "storage.kv", "storage.objectstore",
        "utils.cron", "utils.sortedkeys")}
    wal, kv, obj = mods["storage.wal"], mods["storage.kv"], mods["storage.objectstore"]
    cron = mods["utils.cron"]
    return SimpleNamespace(
        root=root, native=mods["native"], walmod=wal, WAL=wal.WAL,
        BLOCK_SIZE=wal.BLOCK_SIZE, ChunkPosition=wal.ChunkPosition, KV=kv.KV,
        LocalObjectStore=obj.LocalObjectStore, BucketError=obj.BucketError,
        CronSchedule=cron.CronSchedule, CronError=cron.CronError,
        sortedkeys=mods["utils.sortedkeys"],
        SortedKeys=mods["utils.sortedkeys"].SortedKeys)


@pytest.fixture(params=PKGS)
def pkg(request):
    return _pkg(request.param)


@pytest.fixture
def native_pkg(pkg):
    if not pkg.native.available():
        pytest.skip("native library unavailable (no g++ or zlib)")
    return pkg


def _unlock(kv):
    """Release the dir lock without close() (crash simulation)."""
    fcntl.flock(kv._lock_f, fcntl.LOCK_UN)
    kv._lock_f.close()


# -- WAL -------------------------------------------------------------------

def test_wal_write_read_roundtrip(pkg, tmp_path):
    w = pkg.WAL(str(tmp_path / "wal"))
    payloads = [b"hello", b"x" * 10, b"y" * 100_000]  # last spans blocks
    positions = [w.write(p) for p in payloads]
    for p, pos in zip(payloads, positions):
        assert w.read(pos) == p
    w.close()


def test_wal_replay_order_and_positions(pkg, tmp_path):
    w = pkg.WAL(str(tmp_path / "wal"))
    payloads = [f"item{i}".encode() * (i * 1000 + 1) for i in range(8)]
    w.write_batch(payloads)
    w.close()
    w2 = pkg.WAL(str(tmp_path / "wal"))
    got = list(w2.read_all())
    assert [g[0] for g in got] == payloads
    for data, pos in got:
        assert w2.read(pos) == data
    w2.close()


def test_wal_block_boundary_payloads(pkg, tmp_path):
    w = pkg.WAL(str(tmp_path / "wal"))
    bs = pkg.BLOCK_SIZE
    sizes = [bs - 7, bs - 8, bs, bs * 2 + 5, 1]
    with pytest.raises(ValueError):
        w.write(b"")
    positions = [w.write(bytes([i % 251]) * s) for i, s in enumerate(sizes)]
    for i, (s, pos) in enumerate(zip(sizes, positions)):
        assert w.read(pos) == bytes([i % 251]) * s
    w.close()


def test_wal_segment_rotation(pkg, tmp_path):
    w = pkg.WAL(str(tmp_path / "wal"), segment_size=64 * 1024)
    for _ in range(10):
        w.write(b"z" * 20_000)
    assert len(w.segments()) > 1
    assert len(list(w.read_all())) == 10
    w.close()


def test_wal_sync_covers_rotated_segments(pkg, tmp_path):
    w = pkg.WAL(str(tmp_path / "wal"), segment_size=64 * 1024)
    for _ in range(10):
        w.write(b"z" * 20_000)  # rotates several segments
    closed = list(w._unsynced_closed)
    assert closed, "rotation should defer closed-segment fsyncs"
    assert all(os.path.exists(p) for p in closed)
    w.sync()
    assert w._unsynced_closed == []
    for _ in range(10):
        w.write(b"z" * 20_000)
    victim_path = w._unsynced_closed[0]
    victim = int(os.path.basename(victim_path).split(".")[0])
    w.detach_segments([victim])
    assert victim_path not in w._unsynced_closed
    w.sync()
    assert w._unsynced_closed == []
    w.close()


def test_wal_torn_tail_ignored(pkg, tmp_path):
    w = pkg.WAL(str(tmp_path / "wal"))
    w.write(b"good")
    w.close()
    seg = sorted(os.listdir(tmp_path / "wal"))[0]
    with open(tmp_path / "wal" / seg, "ab") as f:
        f.write(b"\xde\xad\xbe\xef\x00\x10\x00garbage")
    w2 = pkg.WAL(str(tmp_path / "wal"))
    assert [d for d, _ in w2.read_all()] == [b"good"]
    w2.close()


def test_wal_failed_fsync_is_retried(tmp_path, monkeypatch):
    """The port keeps a closed segment in the deferred set until its fsync
    succeeds: an fsync that raises once is retried by the next sync()."""
    walmod = importlib.import_module("coltt_tpu_torch.storage.wal")
    w = walmod.WAL(str(tmp_path / "wal"), segment_size=64 * 1024)
    for _ in range(10):
        w.write(b"z" * 20_000)
    closed = set(w._unsynced_closed)
    assert closed
    real, synced, failed = os.fsync, [], []

    def flaky(fd):
        path = os.readlink(f"/proc/self/fd/{fd}")
        if path in closed and not failed:
            failed.append(path)
            raise OSError(errno.EIO, "injected fsync failure")
        synced.append(path)
        real(fd)

    monkeypatch.setattr(os, "fsync", flaky)
    with pytest.raises(OSError):
        w.sync()
    assert failed and failed[0] in w._unsynced_closed
    w.sync()
    assert failed[0] in synced
    assert w._unsynced_closed == []
    w.close()


# -- KV ----------------------------------------------------------------------

def test_kv_basic_ops(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "db"))
    kv.put(b"a", b"1")
    kv.put(b"b", b"2")
    assert kv.get(b"a") == b"1"
    assert kv.exists(b"b")
    assert not kv.exists(b"c")
    kv.delete(b"a")
    assert kv.get(b"a") is None
    assert len(kv) == 1
    kv.close()


def test_kv_replay_after_reopen(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "db"))
    for i in range(20):
        kv.put(f"k{i:03d}".encode(), f"v{i}".encode())
    kv.delete(b"k005")
    kv.close()
    kv2 = pkg.KV(str(tmp_path / "db"))
    assert len(kv2) == 19
    assert kv2.get(b"k007") == b"v7"
    assert kv2.get(b"k005") is None
    kv2.close()


def test_kv_batch_atomicity(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "db"))
    b = kv.new_batch()
    b.put(b"x", b"1")
    b.put(b"y", b"2")
    assert kv.get(b"x") is None  # not visible before commit
    assert b.get(b"x") == b"1"   # visible within the batch
    b.commit()
    assert kv.get(b"x") == b"1" and kv.get(b"y") == b"2"
    kv.close()


def test_kv_ordered_iteration_and_prefix(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "db"))
    for k in [b"col_b", b"col_a", b"zzz", b"col_c"]:
        kv.put(k, k.upper())
    assert [k for k, _ in kv.ascend()] == [b"col_a", b"col_b", b"col_c", b"zzz"]
    assert [k for k, _ in kv.descend()][0] == b"zzz"
    assert kv.keys(b"col_") == [b"col_a", b"col_b", b"col_c"]
    assert [k for k, _ in kv.ascend(start=b"col_b", end=b"col_c")] == [b"col_b", b"col_c"]
    kv.close()


def test_kv_merge_compaction(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "db"), segment_size=32 * 1024)
    for i in range(200):
        kv.put(b"hot", f"v{i}".encode() * 100)
        kv.put(f"cold{i}".encode(), b"x")
    before_segments = len(kv._wal.segments())
    kv.merge()
    assert kv.get(b"hot") == b"v199" * 100
    assert len(kv) == 201
    assert len(kv._wal.segments()) < before_segments
    kv.close()
    kv2 = pkg.KV(str(tmp_path / "db"))
    assert kv2.get(b"cold42") == b"x"
    assert len(kv2) == 201
    kv2.close()


def test_kv_merge_nonblocking_with_concurrent_writes(pkg, tmp_path):
    """Writes complete DURING an in-flight merge of a 100k-record log, held
    by counting them, not by timing them: the writer appends until the
    merge ends, and at least 20 of its appends must finish while the merge
    is running (a merge that held the write lock throughout lets at most
    one through). Concurrent overwrites win over interleaved merge copies,
    live and at replay; reopen agrees with the live view, with the hint
    and by full replay."""
    db_dir = str(tmp_path / "db")
    kv = pkg.KV(db_dir, segment_size=1 << 21)
    n = 100_000
    for base in range(0, n, 1000):
        b = kv.new_batch()
        for i in range(base, base + 1000):
            b.put(b"k%06d" % i, b"v%06d" % i)
        b.commit()
    kv.put(b"expiring", b"gone", ttl=0.05)
    time.sleep(0.1)

    merge_started, merge_done = threading.Event(), threading.Event()
    merge_err = []

    def run_merge():
        try:
            merge_started.set()
            kv.merge()
        except Exception as e:  # pragma: no cover - surfaced by assert below
            merge_err.append(e)
        finally:
            merge_done.set()

    t = threading.Thread(target=run_merge)
    t.start()
    assert merge_started.wait(30)
    during, overwritten, deleted, i = 0, {}, set(), 0
    while not merge_done.is_set():
        key = b"k%06d" % ((i * 7919) % n)
        if i % 17 == 3:
            kv.delete(key)
            deleted.add(key)
            overwritten.pop(key, None)
        else:
            val = b"new%07d" % i
            kv.put(key, val)
            overwritten[key] = val
            deleted.discard(key)
        if not merge_done.is_set():
            during += 1  # this append finished while the merge ran
        i += 1
    t.join(60)
    assert not t.is_alive()
    assert not merge_err, merge_err
    assert during >= 20, f"only {during} writes finished during the merge"

    def check(db):
        for key, val in list(overwritten.items())[:500]:
            assert db.get(key) == val, key
        for key in list(deleted)[:200]:
            assert db.get(key) is None, key
        assert db.get(b"expiring") is None
        untouched = [
            b"k%06d" % j for j in range(0, n, 9973)
            if b"k%06d" % j not in overwritten and b"k%06d" % j not in deleted
        ]
        for key in untouched:
            assert db.get(key) == b"v" + key[1:], key

    check(kv)
    kv.close()
    kv2 = pkg.KV(db_dir)  # hint reopen
    check(kv2)
    kv2.close()
    os.remove(os.path.join(db_dir, "HINT"))
    kv3 = pkg.KV(db_dir)  # full replay: REC_MERGE_PUT vs overwrites by batch id
    assert kv3.replayed_records > 0
    check(kv3)
    kv3.put(b"k000000", b"post-replay")
    kv3.close()
    kv4 = pkg.KV(db_dir)
    assert kv4.get(b"k000000") == b"post-replay"
    kv4.close()


def test_kv_get_survives_concurrent_merges(pkg, tmp_path):
    """get() survives a merge retiring a segment between the index lookup
    and the WAL read (retry path)."""
    kv = pkg.KV(str(tmp_path / "db"), segment_size=1 << 16)
    for i in range(5000):
        kv.put(b"g%05d" % i, b"val%05d" % i)
    stop = threading.Event()
    errs = []

    def reader():
        j = 0
        while not stop.is_set():
            k = b"g%05d" % (j % 5000)
            v = kv.get(k)
            if v is not None and not v.startswith(b"val"):
                errs.append((k, v))
            j += 1

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for th in threads:
        th.start()
    for _ in range(3):
        kv.merge()
    stop.set()
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads)
    assert not errs
    assert kv.get(b"g04999") == b"val04999"
    kv.close()


def test_kv_dir_lock(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "db"))
    with pytest.raises(RuntimeError):
        pkg.KV(str(tmp_path / "db"))
    kv.close()


def test_kv_watch(pkg, tmp_path):
    """Events arrive asynchronously but in order."""
    kv = pkg.KV(str(tmp_path / "db"))
    events = []
    kv.watch(lambda ev, k, v: events.append((ev, k)))
    kv.put(b"a", b"1")
    kv.delete(b"a")
    deadline = time.monotonic() + 5.0
    while len(events) < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert events == [("put", b"a"), ("delete", b"a")]
    kv.close()


def test_kv_watch_slow_watcher_does_not_stall_writers(pkg, tmp_path):
    """A watcher that takes 50 ms an event is served off the write path:
    when 20 writes have returned, the watcher has not seen them all yet
    (a synchronous watcher would have), and it then sees every one, in
    order."""
    kv = pkg.KV(str(tmp_path / "db"))
    seen = []

    def slow(ev, k, v):
        time.sleep(0.05)
        seen.append(k)

    kv.watch(slow)
    for i in range(20):
        kv.put(f"k{i}".encode(), b"v")
    assert len(seen) < 20, "writers waited for the watcher"
    deadline = time.monotonic() + 10.0
    while len(seen) < 20 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert [k.decode() for k in seen] == [f"k{i}" for i in range(20)]
    kv.close()


def test_kv_hint_fast_reopen(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "db"))
    for i in range(500):
        kv.put(f"key{i:04d}".encode(), f"val{i}".encode())
    for i in range(0, 500, 3):
        kv.delete(f"key{i:04d}".encode())
    kv.merge()
    kv.close()

    kv2 = pkg.KV(str(tmp_path / "db"))
    assert kv2.replayed_records == 0  # index came wholly from the hint
    assert len(kv2) == 500 - len(range(0, 500, 3))
    assert kv2.get(b"key0001") == b"val1"
    assert kv2.get(b"key0000") is None
    kv2.put(b"late", b"x")
    kv2.delete(b"key0001")
    kv2._wal.sync()
    _unlock(kv2)  # crash: no fresh hint
    kv3 = pkg.KV(str(tmp_path / "db"))
    assert 0 < kv3.replayed_records <= 4  # 2 records + finish markers only
    assert kv3.get(b"late") == b"x"
    assert kv3.get(b"key0001") is None
    kv3.close()


def test_kv_stale_hint_discarded(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "db"))
    for i in range(50):
        kv.put(f"k{i}".encode(), b"v")
    kv.close()
    path = tmp_path / "db" / "HINT"
    data = bytearray(path.read_bytes())
    struct.pack_into(">I", data, 8, 9999)  # boundary at a missing segment
    path.write_bytes(bytes(data))
    kv2 = pkg.KV(str(tmp_path / "db"))
    assert kv2.replayed_records > 0  # full replay happened
    assert len(kv2) == 50
    kv2.close()


def test_kv_auto_merge(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "db"), segment_size=1 << 16,
                auto_merge_interval_s=0.05)
    blob = b"x" * 4096
    for i in range(64):
        kv.put(f"k{i % 4}".encode(), blob)  # heavy overwrite churn
    before = len(kv._wal.segments())
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if len(kv._wal.segments()) < before and kv._writes_since_merge == 0:
            break
        time.sleep(0.02)
    assert len(kv._wal.segments()) < before  # compaction actually ran
    assert len(kv) == 4 and kv.get(b"k3") == blob
    kv.close()


def test_kv_failed_open_releases_lock(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "db"))
    kv.put(b"a", b"1")
    kv.close()
    (tmp_path / "db" / "FORMAT").write_text("999")
    with pytest.raises(RuntimeError, match="format"):
        pkg.KV(str(tmp_path / "db"))
    (tmp_path / "db" / "FORMAT").write_text("2")
    kv2 = pkg.KV(str(tmp_path / "db"))  # would deadlock if the flock leaked
    assert kv2.get(b"a") == b"1"
    kv2.close()


def test_kv_ttl_expiry(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "kv"))
    kv.put(b"eternal", b"1")
    kv.put(b"fleeting", b"2", ttl=0.05)
    kv.put(b"longer", b"3", ttl=60.0)
    assert kv.get(b"fleeting") == b"2"
    assert kv.ttl(b"fleeting") is not None and kv.ttl(b"fleeting") <= 0.05
    assert kv.ttl(b"eternal") == float("inf")
    time.sleep(0.06)
    assert kv.get(b"fleeting") is None
    assert not kv.exists(b"fleeting")
    assert kv.ttl(b"fleeting") is None
    assert kv.keys() == [b"eternal", b"longer"]
    assert len(kv) == 2
    kv.merge()
    assert kv.get(b"eternal") == b"1"
    assert kv.get(b"longer") == b"3"
    assert 0 < kv.ttl(b"longer") <= 60.0
    kv.close()


def test_kv_ttl_survives_reopen_and_expires_at_replay(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "kv"))
    kv.put(b"k", b"v", ttl=0.05)
    kv.put(b"p", b"q", ttl=60.0)
    kv.close()
    time.sleep(0.06)
    kv2 = pkg.KV(str(tmp_path / "kv"))
    assert kv2.get(b"k") is None
    assert kv2.get(b"p") == b"q"
    kv2.close()


def test_kv_batch_rollback(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "kv"))
    kv.put(b"a", b"1")
    b = kv.new_batch()
    b.put(b"b", b"2")
    b.delete(b"a")
    assert b.get(b"b") == b"2"
    b.rollback()
    b.commit()  # no-op after rollback
    assert kv.get(b"a") == b"1"
    assert kv.get(b"b") is None
    kv.close()


def test_kv_stat(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "kv"))
    for i in range(10):
        kv.put(f"k{i}".encode(), b"x" * 100)
    st = kv.stat()
    assert st["keys"] == 10
    assert st["disk_size"] > 1000
    assert st["segments"] >= 1
    kv.close()


def test_kv_format_guard(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "kv"))
    kv.put(b"a", b"1")
    kv.close()
    assert (tmp_path / "kv" / "FORMAT").read_text() == "2"
    kv2 = pkg.KV(str(tmp_path / "kv"))
    assert kv2.get(b"a") == b"1"
    kv2.close()
    os.remove(tmp_path / "kv" / "FORMAT")
    with pytest.raises(RuntimeError, match="format"):
        pkg.KV(str(tmp_path / "kv"))
    (tmp_path / "kv" / "FORMAT").write_text("999")
    with pytest.raises(RuntimeError, match="format"):
        pkg.KV(str(tmp_path / "kv"))


# -- object store --------------------------------------------------------------

def test_object_store_basic(pkg, tmp_path):
    s = pkg.LocalObjectStore(str(tmp_path / "os"))
    s.create_bucket("col1")
    assert s.bucket_exists("col1")
    assert not s.bucket_exists("nope")
    s.put_object("col1", "a.bin", b"data")
    assert s.get_object("col1", "a.bin") == b"data"
    assert s.get_object("col1", "missing") is None
    assert s.list_objects("col1") == ["a.bin"]
    s.delete_object("col1", "a.bin")
    assert not s.object_exists("col1", "a.bin")
    s.delete_bucket("col1")
    assert not s.bucket_exists("col1")


def test_object_store_versioning_and_gc(pkg, tmp_path):
    s = pkg.LocalObjectStore(str(tmp_path / "os"))
    s.create_bucket("v", versioning=True)
    for i in range(5):
        s.put_object("v", "obj", f"v{i}".encode())
    assert s.get_object("v", "obj") == b"v4"
    assert s.list_versions("v", "obj") == [1, 2, 3, 4]
    assert s.cleanup_versions("v", "obj", keep=2) == 2
    assert s.list_versions("v", "obj") == [3, 4]


def test_object_store_put_requires_bucket(pkg, tmp_path):
    s = pkg.LocalObjectStore(str(tmp_path / "os"))
    with pytest.raises(pkg.BucketError):
        s.put_object("ghost", "x", b"")
    with pytest.raises(pkg.BucketError):
        s.create_bucket("../escape")
    s.create_bucket("ok")
    with pytest.raises(pkg.BucketError):
        s.put_object("ok", "../escape", b"")


# -- native IO library ---------------------------------------------------------

def _payloads(rng, bs):
    return [
        b"x",
        b"hello world" * 3,
        rng.integers(0, 256, bs - 7, dtype=np.uint8).tobytes(),  # exact block
        rng.integers(0, 256, bs * 3 + 17, dtype=np.uint8).tobytes(),  # spans
        rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
    ]


def test_crc32_matches_zlib(native_pkg, rng):
    for n in (0, 1, 7, 100, 70_000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert native_pkg.native.crc32(data) == zlib.crc32(data)


def test_frame_matches_python(native_pkg, tmp_path, rng, monkeypatch):
    """Native-framed and Python-framed segments are byte-identical."""
    pkg = native_pkg
    payloads = _payloads(rng, pkg.BLOCK_SIZE)
    w1 = pkg.WAL(str(tmp_path / "nat"))
    pos1 = w1.write_batch(payloads)
    w1.close()
    monkeypatch.setattr(pkg.native, "available", lambda: False)
    w2 = pkg.WAL(str(tmp_path / "py"))
    pos2 = w2.write_batch(payloads)
    w2.close()
    assert pos1 == pos2
    b1 = open(tmp_path / "nat" / "0000000000.seg", "rb").read()
    b2 = open(tmp_path / "py" / "0000000000.seg", "rb").read()
    assert b1 == b2


def test_cross_replay(native_pkg, tmp_path, rng, monkeypatch):
    """Python-written log replays through the native scanner and back."""
    pkg = native_pkg
    payloads = _payloads(rng, pkg.BLOCK_SIZE)
    monkeypatch.setattr(pkg.native, "available", lambda: False)
    w = pkg.WAL(str(tmp_path / "log"))
    want_pos = w.write_batch(payloads)
    w.close()
    monkeypatch.undo()
    assert pkg.native.available()
    w = pkg.WAL(str(tmp_path / "log"))
    got = list(w.read_all())
    assert [p for p, _ in got] == payloads
    assert [pos for _, pos in got] == want_pos
    for payload, pos in zip(payloads, want_pos):
        assert w.read(pos) == payload
    w.close()


def test_native_scan_stops_at_torn_tail(native_pkg, tmp_path):
    w = native_pkg.WAL(str(tmp_path / "log"))
    w.write_batch([b"alpha", b"beta" * 1000])
    w.close()
    path = tmp_path / "log" / "0000000000.seg"
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-10])  # tear the tail
    w = native_pkg.WAL(str(tmp_path / "log"))
    assert [p for p, _ in w.read_all()] == [b"alpha"]
    w.close()


def test_wal_frame_block_boundary_padding(native_pkg):
    off = native_pkg.BLOCK_SIZE - 3  # the header cannot fit: pad
    framed = native_pkg.native.wal_frame(b"abc", off)
    assert framed[:3] == b"\x00\x00\x00"
    assert native_pkg.native.wal_decode(framed, off) == b"abc"


# -- cron ------------------------------------------------------------------------

def test_cron_parse_basic_fields(pkg):
    c = pkg.CronSchedule("*/15 3 1,15 jan-mar sun")
    assert c.minutes == frozenset({0, 15, 30, 45})
    assert c.hours == frozenset({3})
    assert c.doms == frozenset({1, 15})
    assert c.months == frozenset({1, 2, 3})
    assert c.dows == frozenset({0})


def test_cron_next_after(pkg):
    c = pkg.CronSchedule("*/5 * * * *")
    assert c.next_after(dt.datetime(2026, 8, 21, 12, 3, 20)) == dt.datetime(2026, 8, 21, 12, 5)
    assert c.next_after(dt.datetime(2026, 8, 21, 12, 5)) == dt.datetime(2026, 8, 21, 12, 10)
    # 2026-08-21 is a Friday -> next Monday is 08-24
    assert pkg.CronSchedule("30 2 * * mon").next_after(
        dt.datetime(2026, 8, 21, 12, 0)) == dt.datetime(2026, 8, 24, 2, 30)
    # both day fields restricted -> union: Aug 7 2026 is the first Friday
    assert pkg.CronSchedule("0 0 13 * fri").next_after(
        dt.datetime(2026, 8, 1, 0, 0)) == dt.datetime(2026, 8, 7, 0, 0)
    assert pkg.CronSchedule("0 0 * * 7").dows == frozenset({0})


def test_cron_rejects_bad_exprs(pkg):
    for expr in ("* * * *", "61 * * * *", "*/0 * * * *", "5-1 * * * *",
                 "a * * * *"):
        with pytest.raises(pkg.CronError):
            pkg.CronSchedule(expr)


def test_kv_auto_merge_cron_wiring(pkg, tmp_path):
    kv = pkg.KV(str(tmp_path / "db"), auto_merge_cron="*/5 * * * *")
    assert kv._merger is not None and kv._merger.is_alive()
    assert kv._merge_cron is not None
    kv.close()
    with pytest.raises(pkg.CronError):
        pkg.KV(str(tmp_path / "db2"), auto_merge_cron="not a cron")
    kv2 = pkg.KV(str(tmp_path / "db2"))  # the failed open released the lock
    kv2.close()


# -- sorted keys -------------------------------------------------------------------

def test_sortedkeys_order_membership_and_ranges(pkg):
    sk = pkg.SortedKeys([b"c", b"a", b"b"])
    assert list(sk) == [b"a", b"b", b"c"]
    assert list(reversed(sk)) == [b"c", b"b", b"a"]
    assert b"b" in sk and b"z" not in sk
    sk.add(b"z")
    sk.add(b"z")
    assert len(sk) == 4 and list(sk)[-1] == b"z"
    sk.discard(b"a")
    sk.discard(b"nope")
    assert list(sk) == [b"b", b"c", b"z"]
    sk = pkg.SortedKeys(b"%03d" % i for i in range(0, 100, 2))
    assert sk.range_list(b"010", b"020") == [b"%03d" % i for i in range(10, 21, 2)]
    assert sk.range_list(b"011", b"019") == [b"012", b"014", b"016", b"018"]
    assert sk.range_list(None, b"004") == [b"000", b"002", b"004"]
    assert sk.range_list(b"096", None) == [b"096", b"098"]
    assert sk.range_list(b"200", None) == []
    assert list(sk.irange(b"011", b"019")) == [b"012", b"014", b"016", b"018"]
    assert list(sk.irange()) == list(sk)
    empty = pkg.SortedKeys()
    assert len(empty) == 0 and list(empty) == [] and empty.range_list(b"a", b"z") == []


def test_sortedkeys_randomized_against_a_set(pkg, monkeypatch):
    monkeypatch.setattr(pkg.sortedkeys, "BLOCK", 4)  # split / merge constantly
    rnd = random.Random(7)
    sk, ref = pkg.SortedKeys(), set()
    for step in range(4000):
        k = b"%05d" % rnd.randrange(500)
        if rnd.random() < 0.6:
            sk.add(k)
            ref.add(k)
        else:
            sk.discard(k)
            ref.discard(k)
        if step % 500 == 0:
            assert list(sk) == sorted(ref)
            lo, hi = sorted([b"%05d" % rnd.randrange(500), b"%05d" % rnd.randrange(500)])
            want = sorted(x for x in ref if lo <= x <= hi)
            assert sk.range_list(lo, hi) == want
            assert list(sk.irange(lo, hi)) == want
    assert list(reversed(sk)) == sorted(ref, reverse=True)


# -- across packages ---------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]])
@pytest.mark.parametrize("native_io", [True, False], ids=["native", "python"])
def test_wal_written_by_one_package_replays_in_the_other(
        writer, reader, native_io, tmp_path, rng, monkeypatch):
    w_pkg, r_pkg = _pkg(writer), _pkg(reader)
    if not native_io:
        for p in (w_pkg, r_pkg):
            monkeypatch.setattr(p.native, "available", lambda: False)
    payloads = _payloads(rng, w_pkg.BLOCK_SIZE)
    w = w_pkg.WAL(str(tmp_path / "wal"), segment_size=64 * 1024)
    positions = w.write_batch(payloads)
    w.close()
    r = r_pkg.WAL(str(tmp_path / "wal"))
    got = list(r.read_all())
    assert [p for p, _ in got] == payloads
    assert [tuple(vars(pos).values()) for _, pos in got] == \
        [tuple(vars(pos).values()) for pos in positions]
    assert r.read(r_pkg.ChunkPosition(*vars(positions[3]).values())) == payloads[3]
    r.close()


@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]])
def test_kv_dir_written_by_one_package_opens_in_the_other(writer, reader, tmp_path):
    """Batches, deletes, TTLs, merge records and the hint cross both ways,
    with the hint and by full replay."""
    w_pkg, r_pkg = _pkg(writer), _pkg(reader)
    d = str(tmp_path / "db")
    kv = w_pkg.KV(d, segment_size=32 * 1024)
    for i in range(300):
        kv.put(b"k%04d" % i, b"v%04d" % i * 20)
    for i in range(0, 300, 7):
        kv.delete(b"k%04d" % i)
    kv.put(b"ttl", b"x", ttl=3600.0)
    kv.merge()
    b = kv.new_batch()
    b.put(b"after", b"merge")
    b.delete(b"k0001")
    b.commit()
    want = {k: kv.get(k) for k in kv.keys()}
    kv.close()
    for drop_hint in (False, True):
        if drop_hint:
            os.remove(os.path.join(d, "HINT"))
        kv2 = r_pkg.KV(d)
        assert {k: kv2.get(k) for k in kv2.keys()} == want
        assert 3500 < kv2.ttl(b"ttl") <= 3600
        kv2.put(b"from-reader", b"1")
        kv2.close()
        want[b"from-reader"] = b"1"
    kv3 = w_pkg.KV(d)  # and back
    assert {k: kv3.get(k) for k in kv3.keys()} == want
    kv3.close()

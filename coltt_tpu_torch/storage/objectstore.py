"""Object store with bucket versioning (the MinIO role).

Reference parity: ``pkg/minio`` — bucket CRUD + versioning enable +
versioned cleanup (bucket_handler.go:49-130), object put/get
(object_handler.go:29-51) — and the edge lifecycle job purging old object
versions (edge/edge_helper.go:97-105).

Local-filesystem implementation (zero-egress environment; the interface is
S3-shaped so a real object-store client can slot in). Layout:

    root/<bucket>/<object>                     latest version
    root/<bucket>/.versions/<object>/<n>       retained versions (if enabled)

Writes are atomic (tmp + rename), which is what object-store PUT semantics
give the reference for crash-safety of checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import List, Optional

_VERSIONS_DIR = ".versions"
_BUCKET_META = ".bucket.json"


class BucketError(Exception):
    pass


class LocalObjectStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- buckets -------------------------------------------------------------
    def _bucket_path(self, bucket: str) -> str:
        if not bucket or bucket.startswith(".") or "/" in bucket or os.sep in bucket:
            raise BucketError(f"invalid bucket name {bucket!r}")
        return os.path.join(self.root, bucket)

    def create_bucket(self, bucket: str, *, versioning: bool = False) -> None:
        path = self._bucket_path(bucket)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _BUCKET_META), "w") as f:
            json.dump({"versioning": versioning}, f)

    def bucket_exists(self, bucket: str) -> bool:
        return os.path.isfile(os.path.join(self._bucket_path(bucket), _BUCKET_META))

    def bucket_versioning(self, bucket: str) -> bool:
        try:
            with open(os.path.join(self._bucket_path(bucket), _BUCKET_META)) as f:
                return bool(json.load(f).get("versioning", False))
        except FileNotFoundError:
            return False

    def list_buckets(self) -> List[str]:
        return sorted(
            d
            for d in os.listdir(self.root)
            if os.path.isfile(os.path.join(self.root, d, _BUCKET_META))
        )

    def delete_bucket(self, bucket: str) -> None:
        path = self._bucket_path(bucket)
        if os.path.isdir(path):
            shutil.rmtree(path)

    # -- objects ---------------------------------------------------------------
    def _object_path(self, bucket: str, name: str) -> str:
        if not name or name.startswith((".", "/")) or ".." in name:
            raise BucketError(f"invalid object name {name!r}")
        return os.path.join(self._bucket_path(bucket), name)

    def put_object(self, bucket: str, name: str, data: bytes) -> None:
        self.put_object_stream(bucket, name, lambda f: f.write(data))

    def put_object_stream(self, bucket: str, name: str, writer) -> None:
        """PUT whose payload is produced by ``writer(file)`` writing into
        the (tmp) file directly — multi-GB checkpoints stream to disk
        instead of assembling one host buffer (VERDICT r3 item 9). Same
        atomicity (tmp + rename) and versioning as ``put_object``."""
        if not self.bucket_exists(bucket):
            raise BucketError(f"bucket {bucket!r} does not exist")
        path = self._object_path(bucket, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if self.bucket_versioning(bucket) and os.path.exists(path):
            vdir = os.path.join(self._bucket_path(bucket), _VERSIONS_DIR, name)
            os.makedirs(vdir, exist_ok=True)
            existing = [int(v) for v in os.listdir(vdir) if v.isdigit()]
            nxt = (max(existing) + 1) if existing else 1
            shutil.copy2(path, os.path.join(vdir, str(nxt)))
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                writer(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def get_object(self, bucket: str, name: str) -> Optional[bytes]:
        path = self._object_path(bucket, name)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def open_object(self, bucket: str, name: str):
        """Streaming read: a binary file-like over the object (None if
        missing). The load-side pair of ``put_object_stream``."""
        path = self._object_path(bucket, name)
        try:
            return open(path, "rb")
        except FileNotFoundError:
            return None

    def object_exists(self, bucket: str, name: str) -> bool:
        return os.path.isfile(self._object_path(bucket, name))

    def delete_object(self, bucket: str, name: str) -> None:
        path = self._object_path(bucket, name)
        if os.path.exists(path):
            os.remove(path)
        vdir = os.path.join(self._bucket_path(bucket), _VERSIONS_DIR, name)
        if os.path.isdir(vdir):
            shutil.rmtree(vdir)

    def list_objects(self, bucket: str) -> List[str]:
        base = self._bucket_path(bucket)
        out = []
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != _VERSIONS_DIR]
            for fn in filenames:
                if fn == _BUCKET_META:
                    continue
                out.append(os.path.relpath(os.path.join(dirpath, fn), base))
        return sorted(out)

    # -- version lifecycle (BucketLifeCycleJob parity) ----------------------------
    def list_versions(self, bucket: str, name: str) -> List[int]:
        vdir = os.path.join(self._bucket_path(bucket), _VERSIONS_DIR, name)
        if not os.path.isdir(vdir):
            return []
        return sorted(int(v) for v in os.listdir(vdir) if v.isdigit())

    def cleanup_versions(self, bucket: str, name: str, *, keep: int = 1) -> int:
        """Purge old versions, keeping the newest `keep`. Returns purged count."""
        versions = self.list_versions(bucket, name)
        drop = versions[:-keep] if keep > 0 else versions
        vdir = os.path.join(self._bucket_path(bucket), _VERSIONS_DIR, name)
        for v in drop:
            os.remove(os.path.join(vdir, str(v)))
        return len(drop)

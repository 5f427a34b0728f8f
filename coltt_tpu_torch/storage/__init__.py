"""Storage: the segmented WAL, the KV commit log on it, and the checkpoint
object stores (local filesystem; S3 in :mod:`.s3`)."""

from coltt_tpu_torch.storage.wal import WAL, ChunkPosition
from coltt_tpu_torch.storage.kv import KV
from coltt_tpu_torch.storage.objectstore import LocalObjectStore

__all__ = ["WAL", "ChunkPosition", "KV", "LocalObjectStore"]

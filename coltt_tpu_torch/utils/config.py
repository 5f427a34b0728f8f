"""Configuration system: TOML file + environment overrides.

Reference parity-and-fix: the reference declares a TOML-tagged global
``Config`` (NodeID/Standalone/JetStream/RootLayer, ``config/config.go:46-118``)
but never wrote the file loader — it runs on compile-time defaults with
hardcoded MinIO endpoints (SURVEY.md §5). Here the same shape actually
loads: defaults -> TOML file (stdlib tomllib) -> ``COLTT_*`` env overrides.

Port of ``coltt_tpu/utils/config.py`` with the keys the port reads; a
config file written for the JAX package loads (unknown keys are ignored).
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class RootLayerConfig:
    bind_address: str = "0.0.0.0:50051"
    prof_address: str = "0.0.0.0:10224"
    max_recv_msg_size: int = 10 * 1024 * 1024
    max_send_msg_size: int = 10 * 1024 * 1024
    keepalive_time_s: int = 60
    keepalive_timeout_s: int = 10
    tls_pem: Optional[str] = None
    tls_key: Optional[str] = None


@dataclass
class StorageConfig:
    data_dir: str = "./data_dir"
    object_store_root: str = "./object_store"
    # scheduled compaction of the core mode's KV commit log (diskv
    # AutoMergeCronExpr parity, options.go:55-62): an interval in seconds
    # (0 = off) or a 5-field cron spec (empty = off; it takes precedence
    # over the interval when both are set)
    kv_auto_merge_interval_s: float = 0.0
    kv_auto_merge_cron: str = ""
    # edge / experimental checkpoint backend: "local" (filesystem) or "s3"
    # (the network MinIO / S3 client, pkg/minio parity — storage/s3.py)
    object_store: str = "local"
    s3_endpoint: str = "localhost:9000"   # reference dial target (edge.go:36)
    s3_access_key: str = "minioadmin"     # reference creds default
    s3_secret_key: str = "minioadmin"
    s3_region: str = "us-east-1"
    s3_secure: bool = False


@dataclass
class ServingConfig:
    """Cross-request scan coalescing (engine/batcher.py): concurrent
    unfiltered searches on one collection share a single scan.
    ``scan_batch_max <= 1`` disables it (reference behavior: one scan per
    request)."""

    scan_batch_max: int = 2048
    scan_batch_wait_ms: float = 2.0
    # OPQ rounds for PQ collections (0 disables; ops/pq.py PQCodebook doc)
    pq_opq_iters: int = 4
    # multi-device serving: shard every edge / experimental collection's
    # rows over this many devices and scan through the shard-local scans
    # and merge (parallel/dist_search.py). 1 = single-device (default); 0 =
    # every visible CUDA device; more than are visible raises. With device
    # = "cpu" the shards share the host (a test deployment).
    shards: int = 1
    # comma-separated query-batch sizes searched at LoadCollection (plain
    # and high_resource, k=10), so the first RPCs find the kernels loaded
    # and the allocator warm. Empty string disables.
    precompile_batches: str = "1,8,64"
    # torch device every collection's tensors live on ("cuda", "cuda:1",
    # "cpu"). The fused scan kernel runs only on a CUDA device; on "cpu"
    # the stores take its plain PyTorch version.
    device: str = "cuda"


@dataclass
class Config:
    mode: str = "edge"  # root | edge | experimental
    root_layer: RootLayerConfig = field(default_factory=RootLayerConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)


def _apply_dict(obj, d: dict):
    for f in dataclasses.fields(obj):
        if f.name not in d:
            continue
        v = d[f.name]
        cur = getattr(obj, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply_dict(cur, v)
        else:
            setattr(obj, f.name, v)


def _apply_env(obj, prefix: str):
    for f in dataclasses.fields(obj):
        cur = getattr(obj, f.name)
        key = f"{prefix}_{f.name}".upper()
        if dataclasses.is_dataclass(cur):
            _apply_env(cur, key)
            continue
        raw = os.environ.get(key)
        if raw is None:
            continue
        t = type(cur) if cur is not None else str
        if t is bool:
            setattr(obj, f.name, raw.lower() in ("1", "true", "yes", "on"))
        elif t is int:
            setattr(obj, f.name, int(raw))
        elif t is float:
            setattr(obj, f.name, float(raw))
        else:
            setattr(obj, f.name, raw)


def load_config(path: Optional[str] = None) -> Config:
    cfg = Config()
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            _apply_dict(cfg, tomllib.load(f))
    _apply_env(cfg, "COLTT")
    return cfg

"""Core engine ("root" mode): HNSW collections with a WAL-backed commit log.

Reference parity: ``core/core.go`` + ``core/core_helper.go`` +
``root_layer/root`` — CreateCollection with the full HnswConfig surface
(idl/proto/v3/core.proto CollectionSpec), Insert that writes bitmap index +
HNSW + diskv commit log and *rolls back on any failure*
(rollbackForConsistentHelper, core_helper.go:237-249), Update =
remove+reinsert falling back to Insert for unknown ids (core.go:471-564),
Delete, VectorSearch / FilterSearch / HybridSearch (= HNSW top-3K
intersected with filter candidates, core.go:760-839), CompareDist
(core.go:841-867), fp32 graph snapshots to ``<data_dir>/<col>.raw`` +
bitmap index ``<col>.bin`` on Release/shutdown (core_helper.go:68-195,
exitSnapshot:346), and the msgpack collection registry under the KV key
``collections`` (core_helper.go:257-345).

Crash recovery: every accepted mutation is in the KV commit log before the
RPC acks; a per-collection dirty marker is cleared only by a successful
snapshot, so LoadCollection replays the log whenever the snapshot could be
stale — the reference's implicit replay path, made explicit.

Port of ``coltt_tpu/engine/core.py``. Each collection's device graph lives
on the engine's ``device`` (default ``"cuda"``; the engine raises if CUDA
is asked for and absent). The graph the searches read is f32, as in the
reference; bulk builds compute in bf16. The ``<col>.raw`` / ``<col>.bin``
snapshots and the KV commit log have the JAX package's formats, so either
engine opens what the other wrote.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import msgpack
import numpy as np
import torch

from coltt_tpu_torch.engine.errors import EngineError, ErrorCode
from coltt_tpu_torch.engine.state import CollectionStateManager
from coltt_tpu_torch.index.bitmap import InvertedIndex
from coltt_tpu_torch.ops.distance import Metric, distance_pair
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.ops.score import normalize_score
from coltt_tpu_torch.storage.kv import KV
from coltt_tpu_torch.store.hnsw import HnswConfig, HnswIndex
from coltt_tpu_torch.utils import trace
from coltt_tpu_torch.utils.logging import get_logger
from coltt_tpu_torch.utils.snowflake import SnowflakeNode

log = get_logger("core")

_REGISTRY_KEY = b"collections"
_SEP = "\x1f"


def _scores(dists: np.ndarray, metric: Metric) -> np.ndarray:
    """f32 distances -> 0-100 scores in f32 (the reference's arithmetic)."""
    return normalize_score(torch.from_numpy(np.asarray(dists, np.float32)),
                           metric).numpy()


@dataclass
class CollectionSpec:
    name: str
    dim: int
    metric: Metric = Metric.COSINE
    quantization: Quantization = Quantization.NONE  # PQ/BQ reserved, like the ref
    config: HnswConfig = field(default_factory=HnswConfig)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "dim": self.dim,
            "metric": int(self.metric),
            "quantization": int(self.quantization),
            "config": self.config.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CollectionSpec":
        return cls(
            name=d["name"],
            dim=int(d["dim"]),
            metric=Metric.parse(d["metric"]),
            quantization=Quantization.parse(d.get("quantization", 0)),
            config=HnswConfig.from_dict(d["config"]),
        )


@dataclass
class _CoreCollection:
    spec: CollectionSpec
    hnsw: HnswIndex
    inverted: InvertedIndex  # legacy string-normalized variant (pkg/index)
    metadata: Dict[int, Dict[str, Any]] = field(default_factory=dict)  # slot->md
    id_to_slot: Dict[str, int] = field(default_factory=dict)
    # slot -> external id, "" where a slot holds no row (the one map that
    # way): a batch search's hits take their ids in one gather (ids_at)
    id_col: np.ndarray = field(default_factory=lambda: np.full(0, "", object))

    def set_ids(self, slots, ext_ids) -> None:
        """Write ``ext_ids`` (one id, or one a slot; "" clears) into the id
        column at ``slots``. Past its end the column doubles; the grown
        array is filled whole before it replaces the old one, so a search
        reading the column outside the engine's lock sees a whole array."""
        slots = np.asarray(slots, np.int64).reshape(-1)
        if slots.size == 0:
            return
        need = int(slots.max()) + 1
        if need > len(self.id_col):
            col = np.full(max(need, 2 * len(self.id_col)), "", object)
            col[:len(self.id_col)] = self.id_col
            self.id_col = col
        self.id_col[slots] = ext_ids

    def ids_at(self, slots: np.ndarray) -> List[str]:
        """The external ids at ``slots`` (each >= 0), in one gather; ""
        where a slot holds no row."""
        col = self.id_col
        if slots.size and int(slots.max()) >= len(col):
            # a row the graph took after this column was read: no id yet
            grown = np.full(int(slots.max()) + 1, "", object)
            grown[:len(col)] = col
            col = grown
        return col[slots].tolist()


@dataclass
class CoreSearchHit:
    id: str
    score: float
    metadata: Dict[str, Any]


class CoreEngine:
    def __init__(self, data_dir: str, *, device="cuda",
                 kv_auto_merge_interval_s: Optional[float] = None,
                 kv_auto_merge_cron: Optional[str] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch sees no CUDA device")
        os.makedirs(data_dir, exist_ok=True)
        self.data_dir = data_dir
        self.kv = KV(
            os.path.join(data_dir, "commitlog"),
            auto_merge_interval_s=kv_auto_merge_interval_s,
            auto_merge_cron=kv_auto_merge_cron,
        )
        self.ids = SnowflakeNode(0)
        self.state = CollectionStateManager()
        self._collections: Dict[str, _CoreCollection] = {}
        self._mu = threading.RLock()
        # RegistCollectionStManager parity: registry -> state manager
        raw = self.kv.get(_REGISTRY_KEY)
        self._registry: Dict[str, dict] = (
            {s["name"]: s for s in msgpack.unpackb(raw, raw=False)} if raw else {}
        )
        for name in self._registry:
            self.state.add(name)

    # -- registry -------------------------------------------------------------
    def _save_registry(self) -> None:
        self.kv.put(
            _REGISTRY_KEY,
            msgpack.packb(list(self._registry.values()), use_bin_type=True),
        )

    def _snapshot_path(self, name: str) -> str:
        return os.path.join(self.data_dir, f"{name}.raw")

    def _index_path(self, name: str) -> str:
        return os.path.join(self.data_dir, f"{name}.bin")

    def _new_index(self, spec: CollectionSpec) -> HnswIndex:
        return HnswIndex(spec.dim, metric=spec.metric, config=spec.config,
                         device=self.device)

    def _dirty_key(self, name: str) -> bytes:
        return f"__dirty__{name}".encode()

    def _log_key(self, name: str, ext_id: str) -> bytes:
        return f"{name}{_SEP}{ext_id}".encode()

    # -- lifecycle ---------------------------------------------------------------
    def create_collection(self, spec: CollectionSpec) -> dict:
        with self._mu:
            self.state.require_not_exists(spec.name)
            if spec.dim <= 0:
                raise EngineError("vector_dimension must be positive")
            col = _CoreCollection(
                spec=spec,
                hnsw=self._new_index(spec),
                inverted=InvertedIndex(string_normalize=True),
            )
            self._collections[spec.name] = col
            self._registry[spec.name] = spec.to_dict()
            self._save_registry()
            self.state.add(spec.name)
            self.state.mark_loaded(spec.name)
            log.info("created collection", extra={"kv": {"collection": spec.name}})
            return self.collection_info(spec.name)

    def drop_collection(self, name: str) -> None:
        with self._mu:
            self._collections.pop(name, None)
            self._registry.pop(name, None)
            self._save_registry()
            self.state.remove(name)
            for p in (self._snapshot_path(name), self._index_path(name)):
                if os.path.exists(p):
                    os.remove(p)
            batch = self.kv.new_batch()
            for k in self.kv.keys(f"{name}{_SEP}".encode()):
                batch.delete(k)
            batch.delete(self._dirty_key(name))
            batch.commit()

    def collection_info(self, name: str) -> dict:
        self.state.require_exists(name)
        with self._mu:
            col = self._collections.get(name)
            spec = (
                col.spec if col else CollectionSpec.from_dict(self._registry[name])
            )
            size = len(col.hnsw) if col else 0
            return {
                "spec": spec,
                "size": size,
                "loaded": self.state.loaded(name) and col is not None,
            }

    def load_collection(self, name: str) -> dict:
        with self._mu:
            self.state.require_exists(name)
            if self.state.loaded(name) and name in self._collections:
                return self.collection_info(name)
            spec = CollectionSpec.from_dict(self._registry[name])
            dirty = self.kv.exists(self._dirty_key(name))
            snap = self._snapshot_path(name)
            if not dirty and os.path.exists(snap):
                col = self._load_snapshot(name, spec)
            else:
                col = self._rebuild_from_log(name, spec)
            self._collections[name] = col
            self.state.mark_loaded(name)
            return self.collection_info(name)

    def release_collection(self, name: str) -> str:
        with self._mu:
            self.state.require_exists(name)
            col = self._collections.pop(name, None)
            if col is not None:
                self._write_snapshot(name, col)
            self.state.mark_released(name)
            return f"collection {name} snapshotted and released"

    def close(self) -> None:
        """exitSnapshot parity: snapshot every loaded collection."""
        with self._mu:
            for name in list(self.state.loaded_collections()):
                col = self._collections.get(name)
                if col is not None:
                    self._write_snapshot(name, col)
            self.kv.close()

    # -- mutation -------------------------------------------------------------------
    def _require_col(self, name: str) -> _CoreCollection:
        self.state.require_loaded(name)
        return self._collections[name]

    def _check_dim(self, col: _CoreCollection, vector: np.ndarray) -> np.ndarray:
        v = np.asarray(vector, np.float32).reshape(-1)
        if v.shape[0] != col.spec.dim:
            raise EngineError(
                f"dimension mismatch: got {v.shape[0]}, want {col.spec.dim}"
                " (chkValidDimensionality)"
            )
        return v

    def insert(
        self,
        name: str,
        vector: np.ndarray,
        metadata: Optional[Dict[str, Any]] = None,
        *,
        ext_id: Optional[str] = None,
    ) -> str:
        """Insert with full rollback on partial failure (core.go:398-470)."""
        with self._mu:
            col = self._require_col(name)
            v = self._check_dim(col, vector)
            metadata = dict(metadata or {})
            ext_id = ext_id or str(self.ids.generate())
            if ext_id in col.id_to_slot:
                raise EngineError(f"id {ext_id!r} already exists; use Update")

            slot = None
            indexed = False
            logged_key = None
            try:
                slot = col.hnsw.insert(v)
                col.inverted.add(slot, metadata)
                indexed = True
                col.metadata[slot] = metadata
                col.id_to_slot[ext_id] = slot
                col.set_ids([slot], ext_id)
                record = msgpack.packb(
                    {"id": ext_id, "vector": v.tobytes(), "metadata": metadata},
                    use_bin_type=True,
                )
                batch = self.kv.new_batch()
                batch.put(self._log_key(name, ext_id), record)
                batch.put(self._dirty_key(name), b"1")
                batch.commit()
                logged_key = True
            except EngineError:
                raise
            except Exception as e:
                # rollbackForConsistentHelper parity
                if slot is not None:
                    if indexed:
                        col.inverted.remove(slot, metadata)
                    col.hnsw.remove(slot)
                    col.metadata.pop(slot, None)
                    col.id_to_slot.pop(ext_id, None)
                    col.set_ids([slot], "")
                if logged_key:
                    self.kv.delete(self._log_key(name, ext_id))
                raise EngineError(
                    f"insert failed and was rolled back: {e}",
                    ErrorCode.INTERNAL_FUNC_ERROR,
                ) from e
            return ext_id

    def bulk_insert(
        self,
        name: str,
        vectors: np.ndarray,
        metadatas: Optional[List[Dict[str, Any]]] = None,
        *,
        ext_ids: Optional[List[str]] = None,
    ) -> List[str]:
        """Device-accelerated bulk ingest.

        The reference has no bulk path — its published 1M ingest is one
        Insert RPC per vector (583.83 s, benchmark/bench_insert.py:5-41).
        On an empty collection this builds the whole HNSW graph with
        ``HnswIndex.bulk_build_auto`` (see its docstring for the current
        builder policy and the measured recall/rate trade-offs) and
        commits the log in large KV batches; on a non-empty collection it
        degrades to sequential inserts. All-or-nothing on the empty-path:
        any failure resets the collection to empty (rollback parity).
        Recorded as the span ``engine.bulk_insert``.
        """
        with self._mu, trace.span("engine.bulk_insert"):
            col = self._require_col(name)
            vecs = np.asarray(vectors, np.float32)
            if vecs.ndim != 2 or vecs.shape[1] != col.spec.dim:
                raise EngineError(
                    f"bulk_insert wants [N, {col.spec.dim}] vectors, got "
                    f"{vecs.shape} (chkValidDimensionality)"
                )
            n = vecs.shape[0]
            metadatas = metadatas or [{} for _ in range(n)]
            if len(metadatas) != n:
                raise EngineError("metadatas length != vectors length")
            if ext_ids is None:
                ext_ids = [str(self.ids.generate()) for _ in range(n)]
            elif len(ext_ids) != n:
                raise EngineError("ext_ids length != vectors length")
            if len(set(ext_ids)) != n:
                raise EngineError("duplicate ids in bulk insert")

            if len(col.hnsw) != 0:
                dup = next((i for i in ext_ids if i in col.id_to_slot), None)
                if dup is not None:
                    raise EngineError(f"id {dup!r} already exists; use Update")
                for i in range(n):
                    self.insert(name, vecs[i], metadatas[i], ext_id=ext_ids[i])
                return list(ext_ids)

            try:
                slots = col.hnsw.bulk_build_auto(vecs)
                for i, slot in enumerate(slots):
                    slot = int(slot)
                    md = dict(metadatas[i])
                    col.inverted.add(slot, md)
                    col.metadata[slot] = md
                    col.id_to_slot[ext_ids[i]] = slot
                col.set_ids(slots, ext_ids)
                batch = self.kv.new_batch()
                pending = 0
                for i in range(n):
                    record = msgpack.packb(
                        {"id": ext_ids[i], "vector": vecs[i].tobytes(),
                         "metadata": metadatas[i]},
                        use_bin_type=True,
                    )
                    batch.put(self._log_key(name, ext_ids[i]), record)
                    pending += 1
                    if pending >= 4096:
                        batch.commit()
                        batch = self.kv.new_batch()
                        pending = 0
                batch.put(self._dirty_key(name), b"1")
                batch.commit()
            except EngineError:
                raise
            except Exception as e:
                # all-or-nothing rollback: reset to an empty collection
                self._collections[name] = _CoreCollection(
                    spec=col.spec,
                    hnsw=self._new_index(col.spec),
                    inverted=InvertedIndex(string_normalize=True),
                )
                b = self.kv.new_batch()
                for k in self.kv.keys(f"{name}{_SEP}".encode()):
                    b.delete(k)
                b.commit()
                raise EngineError(
                    f"bulk insert failed and was rolled back: {e}",
                    ErrorCode.INTERNAL_FUNC_ERROR,
                ) from e
            return list(ext_ids)

    def update(
        self, name: str, ext_id: str, vector: np.ndarray,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Remove + reinsert; falls back to Insert when the id is unknown
        (core.go:471-564)."""
        with self._mu:
            col = self._require_col(name)
            if ext_id not in col.id_to_slot:
                return self.insert(name, vector, metadata, ext_id=ext_id)
            self.delete(name, ext_id)
            return self.insert(name, vector, metadata, ext_id=ext_id)

    def delete(self, name: str, ext_id: str) -> bool:
        with self._mu:
            col = self._require_col(name)
            slot = col.id_to_slot.pop(ext_id, None)
            if slot is None:
                return False
            col.set_ids([slot], "")
            md = col.metadata.pop(slot, None)
            col.inverted.remove(slot, md)
            col.hnsw.remove(slot)
            batch = self.kv.new_batch()
            batch.delete(self._log_key(name, ext_id))
            batch.put(self._dirty_key(name), b"1")
            batch.commit()
            return True

    # -- search ------------------------------------------------------------------------
    def _hits(self, col: _CoreCollection, dists, slots, k: int,
              min_score: float = 0.0) -> List[CoreSearchHit]:
        out: List[CoreSearchHit] = []
        scores = _scores(dists, col.spec.metric)
        ids = col.ids_at(np.maximum(np.asarray(slots, np.int64), 0))
        for d, s, score, ext_id in zip(dists, slots, scores.tolist(), ids):
            if s < 0 or not np.isfinite(d):
                continue
            if score < min_score:
                continue
            out.append(
                CoreSearchHit(
                    id=ext_id,
                    score=score,
                    metadata=col.metadata.get(int(s), {}),
                )
            )
            if len(out) >= k:
                break
        return out

    def vector_search(
        self, name: str, vector: np.ndarray, top_k: int = 10,
        *, min_score: float = 0.0, ef: Optional[int] = None,
    ) -> List[CoreSearchHit]:
        with self._mu:
            col = self._require_col(name)
            v = self._check_dim(col, vector)
        d, ids = col.hnsw.search(v[None, :], k=top_k, ef=ef)
        return self._hits(col, d[0], ids[0], top_k, min_score)

    def vector_search_batch(
        self, name: str, vectors: np.ndarray, top_k: int = 10,
        *, min_score: float = 0.0, ef: Optional[int] = None,
        with_metadata: bool = False,
    ):
        """Batch-native HNSW search: one [Q, D] block through one device
        beam search (the beam is natively batched — VectorSearchBatch RPC).

        Returns columnar ``(counts [Q], scores flat, ids flat, mds|None)``
        matching the SearchBatchResponse wire shape. The hits to those
        columns are the span ``engine.flatten``."""
        with self._mu:
            col = self._require_col(name)
            queries = np.asarray(vectors, np.float32)
            if queries.ndim != 2 or queries.shape[1] != col.spec.dim:
                raise EngineError(
                    f"queries must be [Q, {col.spec.dim}]", ErrorCode.INTERNAL_FUNC_ERROR
                )
        d, ids = col.hnsw.search(queries, k=top_k, ef=ef)
        with trace.span("engine.flatten", trace.method()):
            # the hits a row keeps, row-major: a slot, a finite distance,
            # a score at least min_score (compared in float64, as the
            # Python float it goes out as), the first top_k of them
            scores = _scores(d, col.spec.metric)
            keep = (ids >= 0) & np.isfinite(d) & ~(scores.astype(np.float64) < min_score)
            keep &= np.cumsum(keep, axis=1) <= top_k
            counts = keep.sum(axis=1).tolist()
            out_scores = scores[keep].tolist()
            kept = ids[keep]
            out_ids = col.ids_at(kept)
            out_mds: Optional[List[Dict[str, Any]]] = None
            if with_metadata:
                out_mds = [col.metadata.get(s, {}) for s in kept.tolist()]
            trace.count("engine.flatten_rows", len(out_ids))
        return counts, out_scores, out_ids, out_mds

    def filter_search(
        self, name: str, filters: Dict[str, str], top_k: int = 10,
        *, vector: Optional[np.ndarray] = None, min_score: float = 0.0,
    ) -> List[CoreSearchHit]:
        """Exact-match metadata search (PureSearch); when a vector is given,
        candidates are ranked by distance, else insertion order."""
        with self._mu:
            col = self._require_col(name)
            cand = col.inverted.pure_search(filters).ids()
            cand = np.asarray(cand, np.int64).reshape(-1)
            cand = cand[np.asarray(col.ids_at(cand), object) != ""]
            if cand.size == 0:
                return []
            if vector is None:
                # no vector -> unscored candidates (reference parity:
                # core.go FilterSearch returns candidates without scores;
                # normalize_score(0) would fabricate a perfect 100.0)
                return [
                    CoreSearchHit(
                        id=ext_id,
                        score=0.0,
                        metadata=col.metadata.get(int(s), {}),
                    )
                    for s, ext_id in zip(cand[:top_k], col.ids_at(cand[:top_k]))
                ]
            v = self._check_dim(col, vector)
            d = col.hnsw._dist_many(v, cand)
            order = np.argsort(d)[:top_k]
            return self._hits(col, d[order], cand[order], top_k, min_score)

    def hybrid_search(
        self, name: str, vector: np.ndarray, filters: Dict[str, str],
        top_k: int = 10, *, min_score: float = 0.0,
    ) -> List[CoreSearchHit]:
        """HNSW top-3K intersected with filter candidates (core.go:760-839)."""
        with self._mu:
            col = self._require_col(name)
            v = self._check_dim(col, vector)
        d, ids = col.hnsw.search(v[None, :], k=top_k * 3, ef=max(top_k * 3, 32))
        allowed = col.inverted.pure_search(filters)
        keep = [
            (dd, ss)
            for dd, ss in zip(d[0], ids[0])
            if ss >= 0 and allowed.test(int(ss))
        ]
        if not keep:
            return []
        dd, ss = zip(*keep)
        return self._hits(col, np.asarray(dd), np.asarray(ss), top_k, min_score)

    @staticmethod
    def compare_dist(x: np.ndarray, y: np.ndarray, metric: Metric = Metric.COSINE
                     ) -> float:
        """CompareDist parity (core.go:841-867): normalized 0-100 score."""
        metric = Metric.parse(metric)
        d = distance_pair(np.asarray(x, np.float32), np.asarray(y, np.float32), metric)
        return float(normalize_score(d, metric))

    # -- snapshots / recovery --------------------------------------------------------
    def _write_snapshot(self, name: str, col: _CoreCollection) -> None:
        with open(self._snapshot_path(name), "wb") as f:
            col.hnsw.save(f)
        side = {
            "metadata": [[s, m] for s, m in col.metadata.items()],
            "ids": [[i, s] for i, s in col.id_to_slot.items()],
            "inverted": col.inverted.to_bytes(),
        }
        with open(self._index_path(name), "wb") as f:
            f.write(msgpack.packb(side, use_bin_type=True))
        self.kv.delete(self._dirty_key(name))  # snapshot now authoritative

    def _load_snapshot(self, name: str, spec: CollectionSpec) -> _CoreCollection:
        with open(self._snapshot_path(name), "rb") as f:
            hnsw = HnswIndex.load(f, device=self.device)
        with open(self._index_path(name), "rb") as f:
            side = msgpack.unpackb(f.read(), raw=False)
        col = _CoreCollection(
            spec=spec,
            hnsw=hnsw,
            inverted=InvertedIndex.from_bytes(side["inverted"]),
            metadata={int(s): m for s, m in side["metadata"]},
            id_to_slot={i: int(s) for i, s in side["ids"]},
        )
        col.set_ids(list(col.id_to_slot.values()), list(col.id_to_slot))
        return col

    def _rebuild_from_log(self, name: str, spec: CollectionSpec) -> _CoreCollection:
        """Crash recovery: replay the commit log into a fresh graph."""
        col = _CoreCollection(
            spec=spec,
            hnsw=self._new_index(spec),
            inverted=InvertedIndex(string_normalize=True),
        )
        prefix = f"{name}{_SEP}".encode()
        recs = [
            msgpack.unpackb(self.kv.get(key), raw=False)
            for key in self.kv.keys(prefix)
        ]
        n = len(recs)
        if n > 4096:
            # large logs: rebuild the graph with the batched device builder
            vecs = np.stack(
                [np.frombuffer(r["vector"], np.float32) for r in recs]
            )
            slots = col.hnsw.bulk_build_auto(vecs)
            for r, slot in zip(recs, slots):
                slot = int(slot)
                col.inverted.add(slot, r["metadata"])
                col.metadata[slot] = r["metadata"]
                col.id_to_slot[r["id"]] = slot
            col.set_ids(slots, [r["id"] for r in recs])
        else:
            for rec in recs:
                v = np.frombuffer(rec["vector"], np.float32)
                slot = col.hnsw.insert(v)
                col.inverted.add(slot, rec["metadata"])
                col.metadata[slot] = rec["metadata"]
                col.id_to_slot[rec["id"]] = slot
                col.set_ids([slot], rec["id"])
        log.info(
            "rebuilt collection from commit log",
            extra={"kv": {"collection": name, "records": n}},
        )
        return col

"""Carry store state between the JAX package and this port as numpy.

``flat_store_from_arrays`` builds a port :class:`FlatStore` from the
arrays of a JAX ``coltt_tpu.store.flat.FlatStore`` (fetched to numpy) and
its slot maps; :func:`flat_store_to_arrays` is its inverse;
``multivec_store_from_arrays`` / ``multivec_store_to_arrays`` do the same
for a ``MultiVectorStore`` (one array of each kind per field);
``hnsw_index_from_arrays`` / ``hnsw_index_to_arrays`` for an
``HnswIndex`` (its host arrays, levels and adjacency by level). The tests use
them so that both packages search the same state; the snapshot bytes
(:meth:`FlatStore.save` / ``load``) are the on-disk route.

numpy has no bf16 or f8 dtype of its own (JAX uses ``ml_dtypes``), so
codes cross as raw bits (:func:`_from_bits`, :func:`_to_bits`; the flat
index's ``parallel/convert.py`` uses them too): any numpy array of the
code width is accepted and reinterpreted, and :func:`flat_store_to_arrays`
returns bf16 / f8 codes as ``int16`` / ``int8`` bit patterns
(``.view(ml_dtypes.bfloat16)`` gives the JAX dtype back). BQ words cross
as their 32 bits (the reference's uint32, the port's int32). A PQ
codebook crosses as a dict of numpy arrays (:func:`pq_codebook_to_arrays`).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.pq import PQCodebook
from coltt_tpu_torch.ops.quant import Quantization, storage_dtype
from coltt_tpu_torch.store.flat import FlatStore, _INT_VIEW
from coltt_tpu_torch.store.hnsw import HnswConfig, HnswIndex
from coltt_tpu_torch.store.multivec import MultiVectorStore

_NP_INT = {1: np.int8, 2: np.int16, 4: np.int32}
_NP_OF = {torch.float32: np.float32, torch.bool: bool}


def _from_bits(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``dtype`` with the raw bits of ``a`` (any numpy
    array of the element width: ml_dtypes' bf16 / f8 have no torch
    counterpart)."""
    raw = np.ascontiguousarray(a).view(_NP_INT[a.dtype.itemsize])
    return torch.from_numpy(raw.copy()).view(dtype)


def _to_bits(t: torch.Tensor) -> np.ndarray:
    """numpy of ``t``; bf16 / f8 as int16 / int8 bit patterns."""
    t = t.cpu()
    if t.dtype not in (torch.float32, torch.int8, torch.float16, torch.uint8,
                       torch.int32):
        t = t.view(_INT_VIEW[t.element_size()])
    return t.numpy()


def pq_codebook_from_arrays(centroids, rotation=None, coarse=None, *,
                            device="cuda") -> PQCodebook:
    """A port codebook from numpy arrays (a JAX ``PQCodebook``'s
    ``centroids [M, K, dsub]``, ``rotation [D, D]`` and ``coarse [C, D]``,
    fetched): how the reference's trained state crosses."""
    def f32(a):
        return None if a is None else torch.from_numpy(
            np.array(a, np.float32)).to(device)

    return PQCodebook(f32(centroids), f32(rotation), f32(coarse))


def pq_codebook_to_arrays(cb: PQCodebook) -> dict:
    """Inverse of :func:`pq_codebook_from_arrays` (numpy f32)."""
    host = lambda t: None if t is None else t.cpu().numpy()  # noqa: E731
    return {"centroids": host(cb.centroids), "rotation": host(cb.rotation),
            "coarse": host(cb.coarse)}


def flat_store_from_arrays(
    *,
    dim: int,
    metric,
    quantization,
    codes: np.ndarray,
    scale: np.ndarray,
    sqnorm: np.ndarray,
    valid: np.ndarray,
    pk_to_slot: Dict[str, int],
    free: Iterable[int] = (),
    next_slot: Optional[int] = None,
    pqcodes: Optional[np.ndarray] = None,
    rr_codes: Optional[np.ndarray] = None,
    rr_scale: Optional[np.ndarray] = None,
    codebook: Optional[dict] = None,
    device="cuda",
    **options,
) -> FlatStore:
    """A port FlatStore holding exactly these arrays and slot maps.
    ``next_slot`` defaults to one past the highest used slot. ``codes`` is
    what the store scans (a PQ-cache store's f8 cache); ``pqcodes`` a
    PQ-cache store's code rows, ``rr_codes`` / ``rr_scale`` a BQ store's
    rerank copy, ``codebook`` a PQ store's (:func:`pq_codebook_to_arrays`);
    ``options`` are the FlatStore's PQ / BQ settings. ``device`` may be a
    mesh: the rows are then cut into its shards (capacity padded to the
    mesh's quantum)."""
    store = FlatStore(dim, metric=Metric.parse(metric),
                      quantization=Quantization.parse(quantization),
                      device=device, **options)
    dev = store.device
    cap = codes.shape[0]
    width, dtype = store._scan_shape
    store.codes = _from_bits(codes, dtype).reshape(cap, width).to(dev)
    store.scale = torch.from_numpy(
        np.array(scale, np.float32).reshape(cap, 1)).to(dev)
    store.sqnorm = torch.from_numpy(
        np.array(sqnorm, np.float32).reshape(cap)).to(dev)
    store.valid = torch.from_numpy(np.array(valid, bool).reshape(cap)).to(dev)
    if codebook is not None:
        store.codebook = pq_codebook_from_arrays(**codebook, device=dev)
    if store.pq_host:
        store.pqcodes_host = np.array(pqcodes, np.uint8)
    elif store.pq_cache:
        store.pqcodes = torch.from_numpy(np.array(pqcodes, np.uint8)).to(dev)
    if store.bq_rerank:
        rdt = storage_dtype(store.bq_rr_quant)
        store.rr_codes = _from_bits(rr_codes, rdt).reshape(cap, dim).to(dev)
        store.rr_scale = torch.from_numpy(
            np.array(rr_scale, np.float32).reshape(cap, 1)).to(dev)
    store.capacity = cap
    store._fit_layout()
    store._set_keys(pk_to_slot)
    store._free = list(free)
    store._next_slot = (int(next_slot) if next_slot is not None
                        else max(store.slot_to_pk, default=-1) + 1)
    return store


def flat_store_to_arrays(store: FlatStore) -> dict:
    """The store's state as numpy (synced first): the keyword arguments of
    :func:`flat_store_from_arrays`, its PQ / BQ settings included."""
    with store._mu:
        store.sync()
        out = {
            "dim": store.dim,
            "metric": int(store.metric),
            "quantization": int(store.quantization),
            "codes": _to_bits(store.codes),
            "scale": store.scale.cpu().numpy(),
            "sqnorm": store.sqnorm.cpu().numpy(),
            "valid": store.valid.cpu().numpy(),
            "pk_to_slot": dict(store.pk_to_slot),
            "free": list(store._free),
            "next_slot": store._next_slot,
        }
        if store.is_pq:
            out.update(
                pq_subspaces=store.pq_m, pq_centroids=store.pq_centroids,
                pq_train_iters=store.pq_train_iters, pq_cache=store.pq_cache,
                pq_host_codes=store.pq_host, pq_opq_iters=store.pq_opq_iters,
                pq_coarse=store.pq_coarse,
                codebook=(None if store.codebook is None
                          else pq_codebook_to_arrays(store.codebook)))
            if store.pq_cache:
                out["pqcodes"] = np.array(store._pq_code_array() if store.pq_host
                                          else store.pqcodes.cpu().numpy())
        if store.is_bq:
            out.update(bq_rerank=store.bq_rerank, bq_oversample=store.bq_oversample,
                       bq_rerank_dtype=store.bq_rr_quant)
            if store.bq_rerank:
                out["rr_codes"] = _to_bits(store.rr_codes)
                out["rr_scale"] = store.rr_scale.cpu().numpy()
        return out


def multivec_store_from_arrays(
    *,
    fields: Dict[str, int],
    metric,
    quantization,
    codes: Dict[str, np.ndarray],
    scale: Dict[str, np.ndarray],
    sqnorm: Dict[str, np.ndarray],
    valid: np.ndarray,
    pk_to_slot: Dict[str, int],
    free: Iterable[int] = (),
    next_slot: Optional[int] = None,
    device="cuda",
) -> MultiVectorStore:
    """A port MultiVectorStore holding exactly these per-field arrays
    (``codes [cap, D_f]`` of the storage dtype or its bits, ``scale [cap,
    1]``, ``sqnorm [cap]``), the shared ``valid [cap]`` and the slot maps.
    ``next_slot`` defaults to one past the highest used slot. Each array
    may also be a torch tensor (codes of the storage dtype), which is
    moved to ``device`` without a host copy. ``device`` may be a mesh: the
    rows are then cut into its shards."""
    cap = valid.shape[0]
    store = MultiVectorStore(fields, metric=Metric.parse(metric),
                             quantization=Quantization.parse(quantization),
                             device=device)
    dev = store.device

    def put(a, dtype, shape, *, bits=False):
        if not isinstance(a, torch.Tensor):
            a = (_from_bits(a, dtype) if bits
                 else torch.from_numpy(np.array(a, _NP_OF[dtype])))
        return a.to(dev, dtype).reshape(shape)

    for name, dim in store.fields.items():
        store.codes[name] = put(codes[name], store._qdtype, (cap, dim), bits=True)
        store.scale[name] = put(scale[name], torch.float32, (cap, 1))
        store.sqnorm[name] = put(sqnorm[name], torch.float32, (cap,))
    store.valid = put(valid, torch.bool, (cap,))
    store.capacity = cap
    store._fit_layout()
    store.pk_to_slot = dict(pk_to_slot)
    store.slot_to_pk = {slot: pk for pk, slot in store.pk_to_slot.items()}
    store._free = list(free)
    store._next_slot = (int(next_slot) if next_slot is not None
                        else max(store.slot_to_pk, default=-1) + 1)
    return store


def multivec_store_to_arrays(store: MultiVectorStore) -> dict:
    """The store's state as numpy (synced first): the keyword arguments of
    :func:`multivec_store_from_arrays`."""
    with store._mu:
        store.sync()
        return {
            "fields": dict(store.fields),
            "metric": int(store.metric),
            "quantization": int(store.quantization),
            "codes": {n: _to_bits(t) for n, t in store.codes.items()},
            "scale": {n: t.cpu().numpy() for n, t in store.scale.items()},
            "sqnorm": {n: t.cpu().numpy() for n, t in store.sqnorm.items()},
            "valid": store.valid.cpu().numpy(),
            "pk_to_slot": dict(store.pk_to_slot),
            "free": list(store._free),
            "next_slot": store._next_slot,
        }


def hnsw_index_from_arrays(
    vectors,
    levels,
    alive,
    adjacency,
    *,
    entry: int,
    max_level: int,
    count: int,
    next_slot: int,
    config: dict,
    dim: Optional[int] = None,
    metric: Metric = Metric.COSINE,
    device_dtype=torch.float32,
    device="cuda",
) -> HnswIndex:
    """A port :class:`HnswIndex` holding the state of a JAX-package index:
    ``vectors [next, D]`` f32, ``levels [next]``, ``alive [next]``,
    ``adjacency`` one ``[next, width]`` int32 array per level, the entry
    point, max level, live count and next slot, and the ``HnswConfig``
    dict (``config.to_dict()``). Rows past ``next_slot`` are copied too
    when given (the arrays may be capacity-shaped)."""
    vectors = np.asarray(vectors, np.float32)
    n = int(next_slot)
    idx = HnswIndex(dim or vectors.shape[1], metric=metric,
                    config=HnswConfig.from_dict(config),
                    base_capacity=max(n, vectors.shape[0], 1024),
                    device_dtype=device_dtype, device=device)
    rows = vectors.shape[0]
    idx._vecs[:rows] = vectors
    idx._sqn[:rows] = np.einsum("nd,nd->n", vectors, vectors, dtype=np.float32)
    idx._levels[:rows] = np.asarray(levels, np.int32)
    idx._alive[:rows] = np.asarray(alive, bool)
    idx._adj = []
    for a in adjacency:
        a = np.asarray(a, np.int32)
        full = np.full((idx._vecs.shape[0], a.shape[1]), -1, np.int32)
        full[:a.shape[0]] = a
        idx._adj.append(full)
    idx._entry, idx._max_level = int(entry), int(max_level)
    idx._count, idx._next = int(count), n
    return idx


def hnsw_index_to_arrays(index: HnswIndex) -> dict:
    """The inverse of :func:`hnsw_index_from_arrays` (rows 0..next-1),
    for a JAX or a port index alike: both keep their state in numpy."""
    n = index._next
    return {
        "vectors": index._vecs[:n].copy(),
        "levels": index._levels[:n].copy(),
        "alive": index._alive[:n].copy(),
        "adjacency": [a[:n].copy() for a in index._adj],
        "entry": index._entry,
        "max_level": index._max_level,
        "count": index._count,
        "next_slot": n,
        "config": index.config.to_dict(),
        "dim": index.dim,
        "metric": int(index.metric),
    }

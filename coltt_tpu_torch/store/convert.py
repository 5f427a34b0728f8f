"""Carry FlatStore state between the JAX package and this port as numpy.

``flat_store_from_arrays`` builds a port :class:`FlatStore` from the
arrays of a JAX ``coltt_tpu.store.flat.FlatStore`` (fetched to numpy) and
its slot maps; :func:`flat_store_to_arrays` is its inverse. The tests use
them so that both packages search the same state; the snapshot bytes
(:meth:`FlatStore.save` / ``load``) are the on-disk route.

numpy has no bf16 or f8 dtype of its own (JAX uses ``ml_dtypes``), so
codes cross as raw bits (:func:`_from_bits`, :func:`_to_bits`; the flat
index's ``parallel/convert.py`` uses them too): any numpy array of the
code width is accepted and reinterpreted, and :func:`flat_store_to_arrays`
returns bf16 / f8 codes as ``int16`` / ``int8`` bit patterns
(``.view(ml_dtypes.bfloat16)`` gives the JAX dtype back).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.store.flat import FlatStore, _INT_VIEW

_NP_INT = {1: np.int8, 2: np.int16, 4: np.int32}


def _from_bits(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``dtype`` with the raw bits of ``a`` (any numpy
    array of the element width: ml_dtypes' bf16 / f8 have no torch
    counterpart)."""
    raw = np.ascontiguousarray(a).view(_NP_INT[a.dtype.itemsize])
    return torch.from_numpy(raw.copy()).view(dtype)


def _to_bits(t: torch.Tensor) -> np.ndarray:
    """numpy of ``t``; bf16 / f8 as int16 / int8 bit patterns."""
    t = t.cpu()
    if t.dtype not in (torch.float32, torch.int8, torch.float16):
        t = t.view(_INT_VIEW[t.element_size()])
    return t.numpy()


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
    device="cuda",
) -> FlatStore:
    """A port FlatStore holding exactly these arrays and slot maps.
    ``next_slot`` defaults to one past the highest used slot."""
    store = FlatStore(dim, metric=Metric.parse(metric),
                      quantization=Quantization.parse(quantization),
                      device=device)
    cap = codes.shape[0]
    store.codes = _from_bits(codes, store._qdtype).reshape(cap, dim).to(store.device)
    store.scale = torch.from_numpy(
        np.array(scale, np.float32).reshape(cap, 1)).to(store.device)
    store.sqnorm = torch.from_numpy(
        np.array(sqnorm, np.float32).reshape(cap)).to(store.device)
    store.valid = torch.from_numpy(np.array(valid, bool).reshape(cap)).to(store.device)
    store.capacity = cap
    store.pk_to_slot = dict(pk_to_slot)
    store.slot_to_pk = {slot: pk for pk, slot in store.pk_to_slot.items()}
    store._free = list(free)
    store._next_slot = (int(next_slot) if next_slot is not None
                        else max(store.slot_to_pk, default=-1) + 1)
    return store


def flat_store_to_arrays(store: FlatStore) -> dict:
    """The store's state as numpy (synced first): the keyword arguments of
    :func:`flat_store_from_arrays`."""
    with store._mu:
        store.sync()
        return {
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

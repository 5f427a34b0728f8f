"""Bitmap inverted index over metadata fields.

Reference parity: ``pkg/inverted/bitmap_index.go:28-43`` (roaring64 bitmaps
per (index, value) with EQ direct lookup, range ops scanning distinct values
with typed comparison — ``search.go:26-48``, ``satisfiesOp``
``bitmap_index.go:358``), composite AND/OR via bitmap And/Or recursion
(``search.go:50-87``), binary serialization (``save.go:131-229``); and the
legacy string-normalized variant used by core (``pkg/index/bitmap_index.go``
forcedStringTypeChanger:48, PureSearch ``search.go:48``,
SearchWitCandidates ``search.go:23``).

Design: ids here are dense *slot* indices into the store's row axis (not
sparse u64 ids — the slot allocator already densifies), so flat word-array
bitsets beat roaring: every AND/OR/NOT is a contiguous SIMD ``np.bitwise_*``
over uint64 words, and the result converts straight into the gather-index /
mask arrays the store's scans consume. Popcount is ``np.bitwise_count``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import msgpack
import numpy as np

from coltt_tpu_torch.index.filter import (
    CompositeFilter,
    Filter,
    FilterExpression,
    LogicalOp,
    Op,
)

_WORD_BITS = 64
# a bitset holding more ids than this switches to the word array
_SPARSE_MAX = 1024
# values whose word-array encoding would exceed this many bytes are written
# to the checkpoint's "sparse" section (see InvertedIndex.to_bytes)
_DENSE_BYTES_MAX = 1024


class Bitset:
    """Growable bitset over dense slot ids, sparse while it holds few.

    The JAX package's Bitset is a flat word array from slot 0 up to its
    highest id, so a value held by one row costs ``slot / 8`` bytes: a
    unique-valued field (the primary key) costs O(N^2) bytes over a
    collection, 62 GB at 1M rows. Here a bitset keeps a set of ids until
    it holds more than ``_SPARSE_MAX`` of them, then switches to the word
    array. Both forms give the same answers and the same ``to_bytes``.
    """

    __slots__ = ("words", "sparse")

    def __init__(self, words: Optional[np.ndarray] = None):
        self.sparse: Optional[set] = set() if words is None else None
        self.words = (
            np.zeros(0, np.uint64) if words is None else np.asarray(words, np.uint64)
        )

    # -- representation ----------------------------------------------------
    def _densify(self) -> None:
        if self.sparse is not None:
            self.words = self._sparse_words(self.sparse)
            self.sparse = None

    @staticmethod
    def _sparse_words(ids) -> np.ndarray:
        if not ids:
            return np.zeros(1, np.uint64)
        arr = np.fromiter(ids, np.int64, len(ids))
        words = np.zeros(int(arr.max()) // _WORD_BITS + 1, np.uint64)
        np.bitwise_or.at(
            words, arr // _WORD_BITS,
            np.uint64(1) << (arr % _WORD_BITS).astype(np.uint64),
        )
        return words

    def _dense_words(self) -> np.ndarray:
        """The word-array form (a fresh array for a sparse bitset)."""
        if self.sparse is not None:
            return self._sparse_words(self.sparse)
        return self.words

    def _ensure(self, bit: int) -> None:
        need = bit // _WORD_BITS + 1
        if need > len(self.words):
            grown = np.zeros(max(need, 2 * len(self.words)), np.uint64)
            grown[: len(self.words)] = self.words
            self.words = grown

    @staticmethod
    def _aligned(a: "Bitset", b: "Bitset") -> Tuple[np.ndarray, np.ndarray]:
        wa, wb = a._dense_words(), b._dense_words()
        la, lb = len(wa), len(wb)
        if la == lb:
            return wa, wb
        n = max(la, lb)
        pa = np.zeros(n, np.uint64)
        pa[:la] = wa
        pb = np.zeros(n, np.uint64)
        pb[:lb] = wb
        return pa, pb

    # -- single-bit ops ----------------------------------------------------
    def set(self, bit: int) -> None:
        if self.sparse is not None:
            self.sparse.add(int(bit))
            if len(self.sparse) > _SPARSE_MAX:
                self._densify()
            return
        self._ensure(bit)
        self.words[bit // _WORD_BITS] |= np.uint64(1) << np.uint64(bit % _WORD_BITS)

    def clear(self, bit: int) -> None:
        if self.sparse is not None:
            self.sparse.discard(int(bit))
        elif bit // _WORD_BITS < len(self.words):
            self.words[bit // _WORD_BITS] &= ~(
                np.uint64(1) << np.uint64(bit % _WORD_BITS)
            )

    def test(self, bit: int) -> bool:
        if self.sparse is not None:
            return int(bit) in self.sparse
        w = bit // _WORD_BITS
        if w >= len(self.words):
            return False
        return bool((self.words[w] >> np.uint64(bit % _WORD_BITS)) & np.uint64(1))

    # -- set algebra -------------------------------------------------------
    def __and__(self, other: "Bitset") -> "Bitset":
        if self.sparse is not None and other.sparse is not None:
            return Bitset._of(self.sparse & other.sparse)
        if self.sparse is not None or other.sparse is not None:
            small, big = (self, other) if self.sparse is not None else (other, self)
            return Bitset._of({i for i in small.sparse if big.test(i)})
        wa, wb = self._aligned(self, other)
        return Bitset(np.bitwise_and(wa, wb))

    def __or__(self, other: "Bitset") -> "Bitset":
        if self.sparse is not None and other.sparse is not None:
            return Bitset._of(self.sparse | other.sparse)
        wa, wb = self._aligned(self, other)
        return Bitset(np.bitwise_or(wa, wb))

    def andnot(self, other: "Bitset") -> "Bitset":
        if self.sparse is not None:
            return Bitset._of({i for i in self.sparse if not other.test(i)})
        wa, wb = self._aligned(self, other)
        return Bitset(np.bitwise_and(wa, np.bitwise_invert(wb)))

    @classmethod
    def _of(cls, ids) -> "Bitset":
        bs = cls()
        bs.sparse = set(ids)
        if len(bs.sparse) > _SPARSE_MAX:
            bs._densify()
        return bs

    def copy(self) -> "Bitset":
        if self.sparse is not None:
            return Bitset._of(self.sparse)
        return Bitset(self.words.copy())

    # -- queries -----------------------------------------------------------
    def count(self) -> int:
        if self.sparse is not None:
            return len(self.sparse)
        return int(np.bitwise_count(self.words).sum())

    def any(self) -> bool:
        if self.sparse is not None:
            return bool(self.sparse)
        return bool(self.words.any())

    def ids(self) -> np.ndarray:
        """Dense int32 array of set bit positions, ascending."""
        if self.sparse is not None:
            return np.array(sorted(self.sparse), np.int32)
        bits = np.unpackbits(self.words.view(np.uint8), bitorder="little")
        return np.flatnonzero(bits).astype(np.int32)

    def mask(self, n: int) -> np.ndarray:
        """Boolean mask of length n (the masked-scan form for the device)."""
        bits = np.unpackbits(self._dense_words().view(np.uint8), bitorder="little")
        out = np.zeros(n, bool)
        m = min(n, len(bits))
        out[:m] = bits[:m]
        return out

    @classmethod
    def from_ids(cls, ids: Iterable[int]) -> "Bitset":
        return cls._of(int(i) for i in ids)

    # -- serialization -----------------------------------------------------
    def to_bytes(self) -> bytes:
        """The JAX package's encoding: the word array, trailing zeros cut."""
        trimmed = np.trim_zeros(self._dense_words(), "b")
        return trimmed.tobytes()

    @classmethod
    def from_bytes(cls, b: bytes) -> "Bitset":
        if not b:
            return cls()
        bs = cls(np.frombuffer(b, np.uint64).copy())
        if bs.count() <= _SPARSE_MAX:
            return cls._of(bs.ids().tolist())
        return bs

    def dense_nbytes(self) -> int:
        """Length of :meth:`to_bytes` without building it."""
        if self.sparse is not None:
            return (max(self.sparse) // _WORD_BITS + 1) * 8 if self.sparse else 0
        return len(np.trim_zeros(self.words, "b")) * 8

    def sparse_bytes(self) -> bytes:
        """Sorted ids as little-endian int32 (the ``sparse`` checkpoint form)."""
        return self.ids().astype("<i4").tobytes()

    @classmethod
    def from_sparse_bytes(cls, b: bytes) -> "Bitset":
        return cls._of(np.frombuffer(b, "<i4").tolist())


def _type_tag(v: Any) -> str:
    # bool before int: bool is an int subclass in Python.
    if isinstance(v, bool):
        return "b"
    if isinstance(v, int):
        return "i"
    if isinstance(v, float):
        return "f"
    return "s"


class InvertedIndex:
    """Per-collection inverted index: field -> value -> Bitset.

    ``string_normalize=True`` reproduces the legacy core variant
    (pkg/index forcedStringTypeChanger): every value is stringified before
    indexing, and lookups compare strings only.
    """

    def __init__(self, fields: Optional[Iterable[str]] = None, *, string_normalize: bool = False):
        self.string_normalize = string_normalize
        self.shards: Dict[str, Dict[Any, Bitset]] = {}
        self.live = Bitset()  # all currently-indexed slots (for NEQ / PureSearch)
        if fields:
            for f in fields:
                self.shards.setdefault(f, {})

    def _norm(self, v: Any) -> Any:
        if self.string_normalize:
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, float) and v == int(v):
                return str(int(v))
            return str(v)
        if isinstance(v, float) and not isinstance(v, bool) and v == int(v):
            # ints arriving as floats (e.g. via JSON/Struct) unify with ints
            return int(v)
        return v

    # -- mutation ----------------------------------------------------------
    def add(self, slot: int, metadata: Dict[str, Any]) -> None:
        for key, value in metadata.items():
            if value is None:
                continue
            self.shards.setdefault(key, {}).setdefault(
                self._norm(value), Bitset()
            ).set(slot)
        self.live.set(slot)

    def remove(self, slot: int, metadata: Optional[Dict[str, Any]] = None) -> None:
        if metadata is not None:
            for key, value in metadata.items():
                if value is None:
                    continue
                vb = self.shards.get(key, {}).get(self._norm(value))
                if vb is not None:
                    vb.clear(slot)
        else:
            for values in self.shards.values():
                for vb in values.values():
                    vb.clear(slot)
        self.live.clear(slot)

    # -- filter evaluation -------------------------------------------------
    @staticmethod
    def _satisfies(stored: Any, op: Op, want: Any) -> bool:
        """Typed comparison for range ops (satisfiesOp parity,
        pkg/inverted/bitmap_index.go:358, compareValues:99)."""
        if isinstance(stored, bool) != isinstance(want, bool):
            return False
        if isinstance(stored, str) != isinstance(want, str):
            return False
        try:
            if op == Op.GT:
                return stored > want
            if op == Op.GTE:
                return stored >= want
            if op == Op.LT:
                return stored < want
            if op == Op.LTE:
                return stored <= want
        except TypeError:
            return False
        return False

    def _eval_leaf(self, f: Filter) -> Bitset:
        values = self.shards.get(f.index_name, {})
        want = self._norm(f.value)
        if f.op == Op.EQ:
            hit = values.get(want)
            return hit.copy() if hit is not None else Bitset()
        if f.op == Op.NEQ:
            hit = values.get(want)
            return self.live.andnot(hit) if hit is not None else self.live.copy()
        if self.string_normalize:
            raise ValueError("range ops unsupported on string-normalized index")
        out = Bitset()
        for stored, vb in values.items():
            if self._satisfies(stored, f.op, want):
                out = out | vb
        return out

    def search(self, expr: FilterExpression) -> Bitset:
        """Evaluate a filter expression tree to a candidate bitset
        (SearchWithExpression parity, pkg/inverted/search.go:50-113)."""
        if isinstance(expr, Filter):
            return self._eval_leaf(expr)
        if isinstance(expr, CompositeFilter):
            if not expr.expressions:
                return Bitset()
            acc = self.search(expr.expressions[0])
            for sub in expr.expressions[1:]:
                nxt = self.search(sub)
                acc = acc & nxt if expr.op == LogicalOp.AND else acc | nxt
            return acc
        raise TypeError(f"not a filter expression: {expr!r}")

    def pure_search(self, filters: Dict[str, Any]) -> Bitset:
        """Exact-match AND over {field: value} (legacy core PureSearch
        parity, pkg/index/search.go:48)."""
        acc = self.live.copy()
        for key, value in filters.items():
            hit = self.shards.get(key, {}).get(self._norm(value))
            if hit is None:
                return Bitset()
            acc = acc & hit
        return acc

    def search_with_candidates(self, candidates: Iterable[int], filters: Dict[str, Any]) -> Bitset:
        """Intersect candidate ids with an exact-match filter (legacy core
        SearchWitCandidates parity, pkg/index/search.go:23)."""
        return Bitset.from_ids(candidates) & self.pure_search(filters)

    # -- serialization -----------------------------------------------------
    def to_bytes(self) -> bytes:
        """The JAX package's checkpoint layout, plus one section it does not
        read: a value whose word array would take more than
        ``_DENSE_BYTES_MAX`` bytes while holding few ids (a primary key
        beyond slot 8191) is written to ``"sparse"`` as int32 ids instead
        of to ``"shards"``. Collections below 8192 rows therefore encode
        byte-identically to the JAX package's; above, a JAX engine loading
        this checkpoint cannot filter on those values."""
        shards: Dict[str, list] = {}
        sparse: Dict[str, list] = {}
        for fld, values in self.shards.items():
            shards[fld] = []
            for v, vb in values.items():
                if vb.sparse is not None and vb.dense_nbytes() > _DENSE_BYTES_MAX:
                    sparse.setdefault(fld, []).append(
                        [_type_tag(v), v, vb.sparse_bytes()])
                else:
                    shards[fld].append([_type_tag(v), v, vb.to_bytes()])
        payload = {
            "string_normalize": self.string_normalize,
            "live": self.live.to_bytes(),
            "shards": shards,
        }
        if sparse:
            payload["sparse"] = sparse
        return msgpack.packb(payload, use_bin_type=True)

    @staticmethod
    def _typed(tag: str, v: Any) -> Any:
        if tag == "b":
            return bool(v)
        if tag == "i":
            return int(v)
        if tag == "f":
            return float(v)
        return v

    @classmethod
    def from_bytes(cls, b: bytes) -> "InvertedIndex":
        payload = msgpack.unpackb(b, raw=False, strict_map_key=False)
        idx = cls(string_normalize=payload.get("string_normalize", False))
        idx.live = Bitset.from_bytes(payload["live"])
        for fld, entries in payload["shards"].items():
            idx.shards[fld] = {
                cls._typed(tag, v): Bitset.from_bytes(raw) for tag, v, raw in entries
            }
        for fld, entries in payload.get("sparse", {}).items():
            values = idx.shards.setdefault(fld, {})
            for tag, v, raw in entries:
                values[cls._typed(tag, v)] = Bitset.from_sparse_bytes(raw)
        return idx

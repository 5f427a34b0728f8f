"""Device mesh and row-sharded tensors (port of ``coltt_tpu/parallel/mesh.py``).

The corpus ("shard") axis plays the role of the reference's 16 in-process
shards (edge/constants.go EDGE_MAP_SHARD_COUNT); the optional query
("batch") axis is data parallelism over concurrent queries.

JAX's single-controller ``Mesh`` becomes :class:`Mesh`, a ``[shards,
batch]`` grid of ``torch.device``s that one process drives: every shard's
scan is queued on its own device and nothing waits for a device until the
partials merge (``parallel/dist_search.py``). A device may appear more
than once in the grid: a mesh of 8 ``cpu`` shards is what the tests run
on (the counterpart of ``--xla_force_host_platform_device_count`` in
``tests/conftest.py``), and ``cuda:0`` four times runs the sharded code on
one card. Across processes (``parallel/multihost.py``) a mesh holds only
this process's rows of the grid; the shard axis is global and host-major.

:class:`ShardedRows` is the ``P(shard)`` layout: an ``[N, ...]`` tensor
cut into equal row blocks, block ``s`` on ``devices[s][b]`` for every
batch column ``b`` (one tensor per distinct device; a repeated device
shares it). Blocks are separate tensors or disjoint views; nothing writes
a block in place while a search holds it (the stores' out-of-place rule).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

SHARD_AXIS = "shard"
BATCH_AXIS = "batch"


def as_device(d) -> torch.device:
    """A ``torch.device`` with an index for CUDA (``"cuda"`` is the current
    card), so that equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def on_device(d):
    """Context in which kernels launch on ``d`` (a CUDA device's own
    current device and stream); no-op elsewhere."""
    return torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()


class Mesh:
    """A ``[shards, batch]`` grid of torch devices.

    ``devices[s][b]`` holds shard ``s``'s rows and scans query column
    ``b``. In a multi-process mesh ``devices`` holds this process's
    ``local_shards`` rows of the grid, global shards ``shard_offset`` to
    ``shard_offset + local_shards - 1``; ``shape`` and ``size`` are
    global, as JAX's are."""

    def __init__(self, grid: Sequence[Sequence], *, process_index: int = 0,
                 process_count: int = 1, distributed: bool = False):
        self.devices: List[List[torch.device]] = [
            [as_device(d) for d in row] for row in grid]
        if not self.devices or not self.devices[0]:
            raise ValueError("a mesh needs at least one device")
        if len({len(row) for row in self.devices}) != 1:
            raise ValueError("every shard needs the same number of batch columns")
        self.local_shards = len(self.devices)
        self.batch = len(self.devices[0])
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        # partials also merge across processes (parallel/multihost.py)
        self.distributed = bool(distributed)
        self.shards = self.local_shards * self.process_count
        self.shard_offset = self.process_index * self.local_shards
        self.shape = {SHARD_AXIS: self.shards, BATCH_AXIS: self.batch}
        self.size = self.shards * self.batch

    @property
    def device(self) -> torch.device:
        """The first device: where queries arrive and results are merged."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        return (f"Mesh(shards={self.shards}, batch={self.batch}, "
                f"devices={[[str(d) for d in row] for row in self.devices]})")


class Placement(NamedTuple):
    """A placement argument resolved by :func:`split`."""
    mesh: Optional[Mesh]   # None on one device
    device: torch.device   # where queries arrive and results land
    where: object          # what the scans take: the mesh, or the device


def split(where, *, single_as_device: bool = False) -> Placement:
    """The one rule for the ``device`` argument of every index, store,
    converter and engine: a ``torch.device`` (or its name) or a
    :class:`Mesh`. ``single_as_device`` makes a one-device mesh its device,
    as the reference's stores hold such a mesh's rows unsharded; the
    indexes keep it a mesh, and the scans bypass it themselves
    (``parallel/dist_search.py`` ``bypass_single``)."""
    if isinstance(where, Mesh):
        if single_as_device and where.size == 1:
            return Placement(None, where.device, where.device)
        return Placement(where, where.device, where)
    d = torch.device(where)
    return Placement(None, d, d)


def default_devices() -> List[torch.device]:
    """Every visible CUDA device (the mesh's default, as ``jax.devices()``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_mesh: torch sees no CUDA device; pass devices=")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    num_shards: Optional[int] = None,
    *,
    batch: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1D corpus mesh by default; 2D (shard, batch) when batch > 1. The
    reference's rules: ``devices`` defaults to every visible CUDA device,
    ``num_shards`` to ``len(devices) // batch``, and a grid larger than
    ``devices`` raises. Repeat a device in ``devices`` to put several
    shards on it."""
    devices = list(devices if devices is not None else default_devices())
    if num_shards is None:
        num_shards = len(devices) // batch
    need = num_shards * batch
    if need > len(devices) or need < 1:
        raise ValueError(
            f"need {need} devices (shards={num_shards} x batch={batch}), "
            f"have {len(devices)}")
    return Mesh([devices[s * batch:(s + 1) * batch] for s in range(num_shards)])


def replicate(mesh: Mesh, t: Optional[torch.Tensor]) -> Optional[dict]:
    """``t`` on every device of the mesh (the reference's ``P()``
    replication): ``{device: tensor}``."""
    if t is None:
        return None
    out = {}
    for row in mesh.devices:
        for d in row:
            if d not in out:
                out[d] = t.to(d)
    return out


class ShardedRows:
    """Rows of an ``[N, ...]`` tensor cut into ``mesh.shards`` equal
    blocks; ``blocks[s][b]`` is local shard ``s``'s block on
    ``mesh.devices[s][b]``."""

    def __init__(self, mesh: Mesh, blocks: List[List[torch.Tensor]]):
        self.mesh = mesh
        self.blocks = blocks

    # -- construction ----------------------------------------------------
    @classmethod
    def build(cls, mesh: Mesh, n: int,
              fn: Callable[[int, int, torch.device], torch.Tensor]) -> "ShardedRows":
        """Block ``s`` = ``fn(lo, hi, device)`` for global rows ``[lo,
        hi)`` of this process's shards, made on the shard's first device
        and copied to its other columns' devices. ``n`` is the global row
        count, a multiple of the shard count."""
        return cls.build_many(mesh, n, lambda lo, hi, d: (fn(lo, hi, d),))[0]

    @classmethod
    def build_many(cls, mesh: Mesh, n: int, fn):
        """:meth:`build` for an ``fn`` that returns a tuple or a dict of
        blocks (one pass over the rows makes several arrays): a tuple or a
        dict of ShardedRows."""
        if n % mesh.shards:
            raise ValueError(f"rows {n} must divide by shards={mesh.shards}")
        local = n // mesh.shards
        rows = []
        for s in range(mesh.local_shards):
            lo = (mesh.shard_offset + s) * local
            devs = mesh.devices[s]
            with on_device(devs[0]):
                firsts = fn(lo, lo + local, devs[0])
            names = list(firsts) if isinstance(firsts, dict) else None
            row = []
            for first in (firsts.values() if names else firsts):
                made = {devs[0]: first}
                for d in devs:
                    if d not in made:
                        made[d] = first.to(d)
                row.append([made[d] for d in devs])
            rows.append(row)
        out = tuple(cls(mesh, [r[i] for r in rows]) for i in range(len(rows[0])))
        return dict(zip(names, out)) if names else out

    @classmethod
    def place(cls, mesh: Mesh, x, n: Optional[int] = None) -> "ShardedRows":
        """``x`` (a tensor or numpy array of the global rows, or of this
        process's rows when ``n`` gives the global count) cut into the
        mesh's blocks. On a mesh of one device (repeated) the blocks are
        views of ``x``."""
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        total = x.shape[0] if n is None else int(n)
        off = 0 if n is None else (mesh.shard_offset * (total // mesh.shards))
        # a view would keep all of x alive on its device; copy when the
        # other blocks go elsewhere
        spread = len({d for row in mesh.devices for d in row}) > 1

        def block(lo, hi, d):
            t = x[lo - off:hi - off].to(d)
            return t.clone() if spread and t.device == x.device else t

        return cls.build(mesh, total, block)

    # -- shape -------------------------------------------------------------
    def shard(self, s: int, b: int = 0) -> torch.Tensor:
        return self.blocks[s][b]

    @property
    def local_n(self) -> int:
        return self.blocks[0][0].shape[0]

    @property
    def shape(self):
        return (self.local_n * self.mesh.shards, *self.blocks[0][0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][0].dtype

    def _distinct(self, s: int):
        """The distinct tensors of local shard ``s`` (a repeated device's
        columns share one)."""
        return list({id(t): t for t in self.blocks[s]}.values())

    # -- operations -------------------------------------------------------
    def map(self, fn: Callable[[torch.Tensor, int, int], torch.Tensor]) -> "ShardedRows":
        """A new ShardedRows of ``fn(block, lo, hi)`` on every distinct
        block (``[lo, hi)`` its global rows)."""
        local = self.local_n
        blocks = []
        for s, row in enumerate(self.blocks):
            lo = (self.mesh.shard_offset + s) * local
            done = {}
            for t in row:
                if id(t) not in done:
                    with on_device(t.device):
                        done[id(t)] = fn(t, lo, lo + local)
            blocks.append([done[id(t)] for t in row])
        return ShardedRows(self.mesh, blocks)

    def row(self, slot: int) -> torch.Tensor:
        """Global row ``slot`` (this process's shards only)."""
        s, r = divmod(slot, self.local_n)
        return self.blocks[s - self.mesh.shard_offset][0][r]

    def host_blocks(self):
        """This process's blocks in row order (column 0), for streaming."""
        return [row[0] for row in self.blocks]

    def cpu(self) -> torch.Tensor:
        """The rows of this process's shards on the host, in row order."""
        return torch.cat([t.cpu() for t in self.host_blocks()])

    def scatter(self, slots: np.ndarray, src: torch.Tensor, *,
                inplace: bool) -> "ShardedRows":
        """Rows ``src[i]`` written at global rows ``slots[i]`` (sorted
        numpy int64). In place, or into new tensors for the shards the
        write touches (the others are kept), so a live snapshot never sees
        a change. Returns the result (``self`` when in place)."""
        local = self.local_n
        bounds = np.searchsorted(
            slots, (self.mesh.shard_offset + np.arange(self.mesh.local_shards + 1))
            * local)
        blocks = [list(row) for row in self.blocks]
        for s in range(self.mesh.local_shards):
            a, b = int(bounds[s]), int(bounds[s + 1])
            if a == b:
                continue
            lo = (self.mesh.shard_offset + s) * local
            sel = torch.from_numpy(slots[a:b] - lo)
            rows = src[a:b]
            new = {}
            for t in self._distinct(s):
                idx, val = sel.to(t.device), rows.to(t.device)
                new[id(t)] = (t.index_put_((idx,), val) if inplace
                              else t.index_put((idx,), val))
            blocks[s] = [new[id(t)] for t in self.blocks[s]]
        if inplace:
            return self
        return ShardedRows(self.mesh, blocks)

    def regrow(self, n: int, fill: float = 0.0) -> "ShardedRows":
        """The same global rows in a layout of ``n`` rows (``n`` >= the
        current count), new rows ``fill``. Shard boundaries move, so each
        new block is assembled from the old blocks it overlaps, copied to
        its device; no device holds more than its new block."""
        old_local = self.local_n
        old_n = old_local * self.mesh.shards
        tail = self.blocks[0][0].shape[1:]
        if self.mesh.process_count > 1:
            raise NotImplementedError("a multi-process store does not grow")

        def make(lo, hi, d):
            parts = []
            for s in range(self.mesh.shards):
                blo = s * old_local
                a, b = max(lo, blo) - blo, min(hi, blo + old_local) - blo
                if a < b:
                    parts.append(self.blocks[s][0][a:b].to(d))
            if hi > old_n:
                parts.append(torch.full((hi - max(lo, old_n), *tail), fill,
                                        dtype=self.dtype, device=d))
            return torch.cat(parts)

        return ShardedRows.build(self.mesh, n, make)

"""Multi-process serving: the process group, host-major meshes, and
host-local row assembly (port of ``coltt_tpu/parallel/multihost.py``).

JAX's multi-controller runtime becomes ``torch.distributed`` with one
process per host, each driving its own devices:

- every process calls :func:`init_distributed` with the same coordinator
  address (``host:port``), the process count and its own rank;
- :func:`make_multihost_mesh` lays the corpus ("shard") axis out
  host-major: process ``p`` holds global shards ``p * local`` to ``(p + 1)
  * local - 1``, so each shard's scan stays inside its process and the
  only traffic between processes is the ``[Q, k]`` partial merge;
- :func:`assemble_global_rows` places only this process's rows (the rows
  of :func:`host_row_range`) on its own shards; no process holds the
  corpus;
- after each process merges its own shards' partials, the partials of
  every process are all-gathered and merged once more by
  ``ops.topk.stable_topk`` (:func:`merge_across_processes`).

Backend rule, decided from the devices every process will drive, which
the processes exchange through the rendezvous store before the group
starts (:func:`choose_backend`): NCCL when every process drives CUDA cards
and no card is driven by two processes; gloo for CPU meshes, whose
partials are CPU tensors, and for several processes that share a card,
since NCCL refuses two ranks on one GPU. Under gloo only the ``[Q, k]``
partials pass through host memory; the scans stay on the card.

Single process, all of this degrades as in the reference: init is a
no-op, the mesh is the local mesh and assembly is a placement.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from coltt_tpu_torch.ops.topk import stable_topk
from coltt_tpu_torch.parallel.mesh import Mesh, ShardedRows, as_device, default_devices
from coltt_tpu_torch.utils.logging import get_logger

log = get_logger("parallel.multihost")


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def device_keys(devices) -> List[str]:
    """What names each of ``devices`` across processes: ``cuda:<card
    UUID>`` for a card (the same card under any ``CUDA_VISIBLE_DEVICES``),
    else the device type."""
    keys = []
    for d in devices:
        d = as_device(d)
        keys.append(f"cuda:{torch.cuda.get_device_properties(d).uuid}"
                    if d.type == "cuda" else d.type)
    return keys


def choose_backend(per_process: Sequence[Sequence[str]]) -> str:
    """The module's backend rule over every process's :func:`device_keys`:
    NCCL when every device is a card and no card serves two processes,
    else gloo."""
    seen = set()
    for keys in per_process:
        mine = set(keys)
        if not mine or any(not k.startswith("cuda:") for k in mine) or mine & seen:
            return "gloo"
        seen |= mine
    return "nccl"


def init_distributed(
    coordinator_address: Optional[str] = None,
    *,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    devices: Optional[Sequence] = None,
    timeout_s: float = 60.0,
) -> int:
    """Join the process group; returns the process count.

    ``coordinator_address`` (``host:port``, the rendezvous of rank 0)
    starts the group of ``num_processes`` processes, this one ranked
    ``process_id``; without it this is a no-op (one process). ``devices``
    are the devices this process's mesh will hold (default: every visible
    CUDA device, and without one it raises: host shards are asked for as
    ``devices=["cpu", ...]``); the backend is the module's rule over
    every process's devices (:func:`choose_backend`). Joining waits
    at most ``timeout_s`` for the other processes, and a collective as
    long, so a missing peer fails instead of hanging."""
    if coordinator_address is not None and not dist.is_initialized():
        n = 1 if num_processes is None else int(num_processes)
        rank = 0 if process_id is None else int(process_id)
        timeout = datetime.timedelta(seconds=timeout_s)
        # resolved before the rendezvous, so that a box without the cards
        # asked for fails before it opens a store
        devices = [as_device(d) for d in
                   (devices if devices is not None else default_devices())]
        host, port = coordinator_address.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), n, is_master=rank == 0, timeout=timeout)
        store.set(f"coltt/devices/{rank}", ",".join(device_keys(devices)))
        backend = choose_backend([store.get(f"coltt/devices/{r}").decode().split(",")
                                  for r in range(n)])
        if backend == "nccl":
            torch.cuda.set_device(next(d for d in devices if d.type == "cuda"))
        dist.init_process_group(backend, store=store, world_size=n, rank=rank,
                                timeout=timeout)
    nproc = process_count()
    log.info("distributed runtime ready", extra={"kv": {
        "processes": nproc, "process_id": process_index(),
        "backend": dist.get_backend() if dist.is_initialized() else None}})
    return nproc


def make_multihost_mesh(*, batch: int = 1, devices: Optional[Sequence] = None
                        ) -> Mesh:
    """(shard, batch) mesh over every process's devices, host-major.

    ``devices`` are this process's (default: every visible CUDA device);
    each process must pass as many. ``batch`` > 1 carves a query-parallel
    axis out of them and must divide their count, so that a query batch
    never crosses processes."""
    devices = list(devices if devices is not None else default_devices())
    per_host = len(devices)
    if batch < 1 or per_host % batch:
        raise ValueError(
            f"batch={batch} must divide the per-process device count {per_host} "
            "so query batches stay inside a process")
    grid = [devices[s * batch:(s + 1) * batch] for s in range(per_host // batch)]
    return Mesh(grid, process_index=process_index(), process_count=process_count(),
                distributed=dist.is_available() and dist.is_initialized())


def host_row_range(n: int, mesh: Mesh) -> tuple[int, int]:
    """``[start, end)`` of the global ``[N]`` row axis this process's shards
    own: rows are block-partitioned over the shard axis and a process's
    shards are consecutive (the mesh is host-major)."""
    if n % mesh.shards:
        raise ValueError(f"n={n} must be divisible by shards={mesh.shards}")
    per = n // mesh.shards
    return mesh.shard_offset * per, (mesh.shard_offset + mesh.local_shards) * per


def assemble_global_rows(mesh: Mesh, local_rows, n: int) -> ShardedRows:
    """The global ``[n, ...]`` shard-axis rows from this process's rows:
    ``local_rows`` (numpy or a tensor) must be exactly the rows of
    :func:`host_row_range`. One process: all ``n`` rows, placed."""
    if mesh.process_count == 1:
        if local_rows.shape[0] != n:
            raise ValueError(
                f"single-process assembly needs all {n} rows, "
                f"got {local_rows.shape[0]}")
        return ShardedRows.place(mesh, local_rows)
    start, end = host_row_range(n, mesh)
    if local_rows.shape[0] != end - start:
        raise ValueError(
            f"process owns rows [{start}, {end}) = {end - start} rows, "
            f"got {local_rows.shape[0]}")
    return ShardedRows.place(mesh, local_rows, n=n)


def _comm_device() -> torch.device:
    """Where collectives run: this process's card under NCCL, host memory
    under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def max_across_processes(t: torch.Tensor) -> torch.Tensor:
    """The element-wise max of ``t`` over every process, on ``t``'s
    device."""
    out = t.to(_comm_device()).clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out.to(t.device)


def merge_across_processes(negd: torch.Tensor, ids: torch.Tensor, k: int):
    """Every process's ``[Q, k]`` partial (this process's shards already
    merged) all-gathered in rank order, which is shard order, and merged
    by one more stable top-k: among equal values the lower global id
    first, as the one-process merge. Returns the merged pair on ``negd``'s
    device."""
    home, dev = negd.device, _comm_device()
    v, i = negd.to(dev).contiguous(), ids.to(dev, torch.int64).contiguous()
    world = dist.get_world_size()
    all_v = [torch.empty_like(v) for _ in range(world)]
    all_i = [torch.empty_like(i) for _ in range(world)]
    dist.all_gather(all_v, v)
    dist.all_gather(all_i, i)
    cat_v, cat_i = torch.cat(all_v, dim=1), torch.cat(all_i, dim=1)
    mv, sel = stable_topk(cat_v, min(k, cat_v.shape[1]))
    return mv.to(home), torch.gather(cat_i, 1, sel).to(home)


__all__ = ["init_distributed", "make_multihost_mesh", "host_row_range",
           "assemble_global_rows", "merge_across_processes", "max_across_processes",
           "process_count", "process_index", "choose_backend", "device_keys"]

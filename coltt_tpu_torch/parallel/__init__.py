"""Multi-device / multi-process parallel layer (port of ``coltt_tpu/parallel``).

The reference's 16-way goroutine shard scan becomes a corpus axis sharded
over a :class:`~coltt_tpu_torch.parallel.mesh.Mesh` of torch devices, with
a per-shard local top-k and a merge of the ``[Q, k]`` partials; the query
axis of the mesh is data parallelism over concurrent queries; across
processes the partials merge once more through ``torch.distributed``.

The JAX package also exports ``shard_spec`` and ``replicated_spec`` (and
defines ``batch_spec``): ``jax.sharding`` partition specs, which have no
torch counterpart. Here a :class:`Mesh` and :class:`ShardedRows` say where
rows live, so those names are not ported.
"""

from coltt_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    SHARD_AXIS,
    Mesh,
    ShardedRows,
    make_mesh,
    replicate,
)
from coltt_tpu_torch.parallel.dist_search import DistributedFlatIndex, sharded_scan_topk
from coltt_tpu_torch.parallel.multihost import (
    assemble_global_rows,
    host_row_range,
    init_distributed,
    make_multihost_mesh,
)

__all__ = [
    "SHARD_AXIS",
    "BATCH_AXIS",
    "Mesh",
    "ShardedRows",
    "make_mesh",
    "replicate",
    "sharded_scan_topk",
    "DistributedFlatIndex",
    "init_distributed",
    "make_multihost_mesh",
    "host_row_range",
    "assemble_global_rows",
]

"""Worker process of ``tests/test_torch_distributed.py``.

    python tests/torch_distributed_worker.py <host:port> <num_procs> <proc_id>

Each process drives 4 ``cpu`` shards (8 global over 2 processes), joins
the gloo process group at ``host:port`` (60 s timeout), builds the
host-major mesh, places only ITS rows of the corpus (assemble_global_rows)
and runs a dense, a PQ, a CFLAT and a unit-i8 search whose merge crosses
the process boundary. Each result must equal the one-process search of
the port on the whole corpus (regenerated from the shared seed) and, for
the dense scan, a numpy exact scan; the unit-i8 index's global scale and
codes must equal the one-process index's. The backend is left to
``init_distributed``'s rule. Imports nothing of JAX.
"""

import sys

import numpy as np
import torch


def main() -> None:
    coordinator, num_procs, proc_id = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    import torch.distributed as dist

    from coltt_tpu_torch.ops.distance import Metric
    from coltt_tpu_torch.ops.pq import pq_encode, train_pq
    from coltt_tpu_torch.ops.quant import Quantization
    from coltt_tpu_torch.parallel import dist_search as tds
    from coltt_tpu_torch.parallel.multihost import (
        assemble_global_rows, host_row_range, init_distributed, make_multihost_mesh,
    )

    # the module's rule picks gloo for cpu shards
    assert init_distributed(coordinator, num_processes=num_procs, process_id=proc_id,
                            devices=["cpu"] * 4, timeout_s=60) == num_procs
    assert dist.get_backend() == "gloo"
    mesh = make_multihost_mesh(devices=["cpu"] * 4)
    assert mesh.shards == 4 * num_procs and mesh.distributed
    n, d, q, k = 1024, 64, 8, 10
    rng = np.random.default_rng(7)  # the same corpus in every process
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    tq = torch.from_numpy(queries)
    start, end = host_row_range(n, mesh)
    assert (start, end) == (proc_id * n // num_procs, (proc_id + 1) * n // num_procs)

    def mine(a):  # this process's rows only
        return assemble_global_rows(mesh, a[start:end], n)

    sqn = (vecs * vecs).sum(1)
    valid = np.ones(n, bool)
    codes = mine(vecs)
    assert codes.shape == (n, d) and len(codes.blocks) == 4
    scores, ids = tds.sharded_scan_topk(mesh, codes, None, mine(sqn), mine(valid), tq,
                                        k=k, metric=Metric.COSINE,
                                        compute_dtype=torch.float32)
    full = [torch.from_numpy(a) for a in (vecs, sqn, valid)]
    s1, i1 = tds.sharded_scan_topk("cpu", full[0], None, full[1], full[2], tq, k=k,
                                   metric=Metric.COSINE, compute_dtype=torch.float32)
    np.testing.assert_array_equal(ids.numpy(), i1.numpy())
    np.testing.assert_allclose(scores.numpy(), s1.numpy(), rtol=2e-7, atol=1e-5)
    sim = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ (
        vecs / np.linalg.norm(vecs, axis=1, keepdims=True)).T
    np.testing.assert_array_equal(ids.numpy(), np.argsort(-sim, axis=1)[:, :k])

    # PQ: the same codebook in every process (seeded training), each
    # process encoding only its rows
    cb = train_pq(torch.from_numpy(vecs), m=8, n_centroids=32, iters=4, sample_size=n)
    pcodes, psqn = pq_encode(torch.from_numpy(vecs[start:end]), cb)
    ps, pi = tds.sharded_pq_topk(
        mesh, assemble_global_rows(mesh, pcodes, n), cb.centroids,
        assemble_global_rows(mesh, psqn, n), mine(valid), tq, k=k,
        metric=Metric.COSINE, rotation=cb.rotation, coarse=cb.coarse)
    acodes, asqn = pq_encode(torch.from_numpy(vecs), cb)
    rs, ri = tds.sharded_pq_topk("cpu", acodes, cb.centroids, asqn, full[2], tq, k=k,
                                 metric=Metric.COSINE, rotation=cb.rotation,
                                 coarse=cb.coarse)
    np.testing.assert_array_equal(pi.numpy(), ri.numpy())
    np.testing.assert_allclose(ps.numpy(), rs.numpy(), rtol=2e-7, atol=1e-5)

    # CFLAT: two fields, the weighted sum across the process boundary
    v2 = rng.standard_normal((n, d // 2)).astype(np.float32)
    q2 = torch.from_numpy(rng.standard_normal((q, d // 2)).astype(np.float32))
    fields = ((mine(vecs), None, mine(sqn)), (mine(v2), None, mine((v2 * v2).sum(1))))
    cs, ci = tds.sharded_cflat_topk(mesh, fields, mine(valid), (tq, q2), (0.7, 0.3),
                                    k=k, compute_dtype=torch.float32)
    one = ((full[0], None, full[1]),
           (torch.from_numpy(v2), None, torch.from_numpy((v2 * v2).sum(1))))
    os_, oi = tds.sharded_cflat_topk("cpu", one, full[2], (tq, q2), (0.7, 0.3), k=k,
                                     compute_dtype=torch.float32)
    np.testing.assert_array_equal(ci.numpy(), oi.numpy())
    np.testing.assert_allclose(cs.numpy(), os_.numpy(), rtol=2e-7, atol=1e-5)

    # unit-i8 (K2's plain version here): the one global scale is the max
    # over every process's rows; the largest component sits in the last
    # process's rows, so a scale taken over any one process's rows differs
    un, ud = 40_000, 128
    urows = rng.standard_normal((un, ud)).astype(np.float32)
    urows[39_000] = 0.0
    urows[39_000, 0] = 5.0  # a unit component of 1.0; every other row's is far lower
    uq = rng.standard_normal((q, ud)).astype(np.float32)
    uq[0] = urows[39_000]
    kw = dict(quantization=Quantization.I8, rerank_dtype=torch.bfloat16, unit_i8=True)
    sharded = tds.DistributedFlatIndex(mesh, urows, **kw)
    one = tds.DistributedFlatIndex("cpu", urows, **kw)
    assert float(sharded.gscale[torch.device("cpu")]) == float(one.gscale)
    lo, hi = host_row_range(sharded.codes.shape[0], mesh)
    hi = min(hi, un)  # the two indexes pad differently; the real rows
    np.testing.assert_array_equal(sharded.codes.cpu()[:hi - lo].numpy(),
                                  one.codes[lo:hi].numpy())
    us, ui = sharded.search(uq, k, oversample=4)
    os1, oi1 = one.search(uq, k, oversample=4)
    np.testing.assert_array_equal(ui, oi1)
    np.testing.assert_allclose(us, os1, rtol=2e-7, atol=1e-5)
    assert ui[0, 0] == 39_000

    dist.destroy_process_group()
    print(f"OK-{proc_id}", flush=True)


if __name__ == "__main__":
    main()

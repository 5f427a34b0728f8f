"""Core mode (``--mode root``): one HNSW collection of a ``CoreEngine``
behind the program's ``CoreServicer`` and gRPC server.

Built with the program's own ``api/server.py`` ``build_servicer("root",
cfg)`` and ``create_server``, bound to ``127.0.0.1:0``; the data directory
(the commit log) lives in the run's working directory. Ingest is the
engine's bulk entry: ``create_collection`` with the configuration's HNSW
settings, then ``bulk_insert`` (the graph built by ``bulk_build_auto``, the
rows logged in batches) with every row's id its row number as a string
(``ext_ids``) and its integer field the row number too; then one sync of
the commit log, so the acknowledged load is durable before serving.
"""

from __future__ import annotations

import os

SERVICE = "colttpu.core.v1.CoreService"


class Deployment:
    def __init__(self, config: dict, workdir: str, device: str, tracer=None):
        from coltt_tpu_torch.api.server import build_servicer, create_server
        from coltt_tpu_torch.utils.config import Config

        cfg = Config()
        cfg.mode = "root"
        cfg.root_layer.bind_address = "127.0.0.1:0"
        cfg.storage.data_dir = os.path.join(workdir, "data")
        cfg.serving.device = device
        self.config, self.tracer = config, tracer
        self.collection = config["collection"]
        self.servicer = build_servicer("root", cfg)
        self.engine = self.servicer.engine
        if tracer is not None:
            tracer.wrap(self.servicer, "VectorSearchBatch", "rpc.VectorSearchBatch",
                        servicer=True)
            tracer.wrap(self.engine, "vector_search_batch",
                        "engine.vector_search_batch")
        self.server = create_server(self.servicer, cfg)
        self.address = f"127.0.0.1:{self.server.bound_port}"

    def ingest(self, rows) -> None:
        """Create the collection, bulk-insert every row, sync the commit
        log, start serving."""
        from coltt_tpu_torch.engine.core import CollectionSpec
        from coltt_tpu_torch.ops.distance import Metric
        from coltt_tpu_torch.store.hnsw import HnswConfig

        c = self.config
        spec = CollectionSpec(self.collection, c["dim"], Metric.parse(c["metric"]),
                              config=HnswConfig(**c["hnsw"]))
        self.engine.create_collection(spec)
        ints = [f["name"] for f in c["fields"] if not f.get("primary_key")]
        n = rows.shape[0]
        self.engine.bulk_insert(self.collection, rows,
                                [{f: i for f in ints} for i in range(n)],
                                ext_ids=[str(i) for i in range(n)])
        self.engine.kv.sync()
        if self.tracer is not None:
            # the graph's widths, for the bytes its searches move
            hnsw = self.engine._collections[self.collection].hnsw
            self.tracer.logs["hnsw_graph"] = [
                {"dim": hnsw.dim, "m0": hnsw.config.m_max0}]
        self.server.start()

    def stop(self) -> None:
        self.server.stop(grace=None).wait()
        self.engine._collections.clear()
        self.engine.kv.close()
        self.servicer = self.engine = None

"""Edge mode (``--mode edge``): one collection of an ``EdgeEngine`` behind
the program's ``EdgeServicer`` and gRPC server.

Built with the program's own ``api/server.py`` ``build_servicer("edge",
cfg)`` and ``create_server``, bound to ``127.0.0.1:0``; the object store
lives in the run's working directory. Ingest is the engine's bulk entry,
``create_collection`` + ``index_many``: every row's primary key is its row
number as a string, and each integer field holds the row number too.
"""

from __future__ import annotations

import os
import time

SERVICE = "colttpu.edge.v1.EdgeService"


class Deployment:
    def __init__(self, config: dict, workdir: str, device: str, tracer=None):
        from coltt_tpu_torch.api.server import build_servicer, create_server
        from coltt_tpu_torch.utils.config import Config

        cfg = Config()
        cfg.mode = "edge"
        cfg.root_layer.bind_address = "127.0.0.1:0"
        cfg.storage.object_store_root = os.path.join(workdir, "objects")
        cfg.storage.data_dir = os.path.join(workdir, "data")
        cfg.serving.device = device
        for key, value in config.get("serving", {}).items():
            setattr(cfg.serving, key, value)
        self.config, self.tracer = config, tracer
        self.collection = config["collection"]
        self.servicer = build_servicer("edge", cfg)
        self.engine = self.servicer.engine
        self.k1_calls: list = []
        if tracer is not None:
            for rpc in ("SearchBatch", "Search"):
                tracer.wrap(self.servicer, rpc, f"rpc.{rpc}", servicer=True)
            tracer.wrap(self.engine, "search_batch", "engine.search_batch")
            tracer.wrap(self.engine, "search", "engine.search")
            tracer.capture_log("coltt.edge", "search_batch")
        self.server = create_server(self.servicer, cfg)
        self.address = f"127.0.0.1:{self.server.bound_port}"

    def ingest(self, rows) -> None:
        """Create the collection, index every row, start serving."""
        from coltt_tpu_torch.index.schema import CollectionSchema, FieldSchema

        c = self.config
        fields = tuple(FieldSchema(f["name"], f["type"],
                                   primary_key=f.get("primary_key", False))
                       for f in c["fields"])
        schema = CollectionSchema(self.collection, c["dim"], c["metric"],
                                  c["quantization"], fields)
        self.engine.create_collection(schema)
        pk = schema.primary_key
        ints = [f.name for f in fields if not f.primary_key]
        mds = [{pk: str(i), **{f: i for f in ints}} for i in range(rows.shape[0])]
        self.engine.index_many(self.collection, mds, rows)
        if self.tracer is not None:
            self._trace_scan()
        self.server.start()

    def _trace_scan(self) -> None:
        from coltt_tpu_torch.ops import fused_scan as fs

        t = self.tracer
        if self.engine._batcher is not None:
            t.wrap(self.engine._batcher, "run", "batcher.run")
        store = self.engine._collections[self.collection].store
        t.wrap(store, "search", "store.search")
        orig, calls = fs.fused_scan_keys, self.k1_calls

        def keys(queries, codes, *args, **kwargs):
            out = orig(queries, codes, *args, **kwargs)
            calls.append((time.monotonic(), int(out["queries"].shape[0]),
                          int(codes.shape[0]), int(codes.shape[1]),
                          str(codes.dtype).removeprefix("torch.")))
            return out

        t.patch(fs, "fused_scan_keys", keys)

    def stop(self) -> None:
        self.server.stop(grace=None).wait()
        self.engine._collections.clear()
        self.servicer = self.engine = None

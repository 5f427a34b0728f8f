"""The S3 object-store client of both packages against ``tests/fake_s3.py``.

The cases of ``tests/test_s3.py`` run against the JAX package's client and
the port's own copy through the ``pkg`` fixture: bucket CRUD, versioning
and version GC, errors, a streamed multipart PUT and a streamed read, and
an edge checkpoint round trip through the network client. Then an edge
checkpoint flushed by one package's engine to S3 is loaded by the other's,
both ways, and the port's server is built with ``object_store = "s3"``.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from fake_s3 import start_fake_s3

PKGS = ("coltt_tpu", "coltt_tpu_torch")


def _pkg(root: str) -> SimpleNamespace:
    s3 = importlib.import_module(f"{root}.storage.s3")
    edge = importlib.import_module(f"{root}.engine.edge")
    schema = importlib.import_module(f"{root}.index.schema")
    quant = importlib.import_module(f"{root}.ops.quant")
    obj = importlib.import_module(f"{root}.storage.objectstore")

    def engine(store):
        if root == "coltt_tpu":
            return edge.EdgeEngine(store, batch_max=1, precompile_batches=())
        return edge.EdgeEngine(store, device="cpu", batch_max=1, warmup_batches=())

    return SimpleNamespace(root=root, S3ObjectStore=s3.S3ObjectStore, S3Error=s3.S3Error,
                           engine=engine, schema=schema, Quantization=quant.Quantization,
                           LocalObjectStore=obj.LocalObjectStore)


@pytest.fixture(params=PKGS)
def pkg(request):
    return _pkg(request.param)


@pytest.fixture
def server():
    srv, addr = start_fake_s3()
    yield addr
    srv.shutdown()


def test_bucket_lifecycle(pkg, server):
    s3 = pkg.S3ObjectStore(server, "minioadmin", "minioadmin")
    assert s3.list_buckets() == []
    s3.create_bucket("col1")
    s3.create_bucket("col2", versioning=True)
    assert s3.bucket_exists("col1")
    assert not s3.bucket_exists("ghost")
    assert s3.list_buckets() == ["col1", "col2"]
    assert not s3.bucket_versioning("col1")
    assert s3.bucket_versioning("col2")
    s3.delete_bucket("col1")
    assert s3.list_buckets() == ["col2"]
    s3.delete_bucket("ghost")  # idempotent


def test_object_roundtrip(pkg, server):
    s3 = pkg.S3ObjectStore(server)
    s3.create_bucket("b")
    assert s3.get_object("b", "x.bin") is None
    assert not s3.object_exists("b", "x.bin")
    payload = bytes(range(256)) * 100
    s3.put_object("b", "x.bin", payload)
    assert s3.get_object("b", "x.bin") == payload
    assert s3.object_exists("b", "x.bin")
    s3.put_object("b", "sub.dir/y.bin", b"nested")
    assert s3.list_objects("b") == ["sub.dir/y.bin", "x.bin"]
    s3.delete_object("b", "x.bin")
    assert s3.get_object("b", "x.bin") is None
    s3.delete_bucket("b")  # purges the remaining objects first
    assert not s3.bucket_exists("b")


def test_versioning_and_cleanup(pkg, server):
    s3 = pkg.S3ObjectStore(server)
    s3.create_bucket("v", versioning=True)
    for i in range(5):
        s3.put_object("v", "obj", f"rev{i}".encode())
    assert s3.get_object("v", "obj") == b"rev4"
    assert len(s3.list_versions("v", "obj")) == 5
    assert s3.cleanup_versions("v", "obj", keep=2) == 3
    assert len(s3.list_versions("v", "obj")) == 2
    assert s3.get_object("v", "obj") == b"rev4"


def test_error_surfaces(pkg, server):
    s3 = pkg.S3ObjectStore(server)
    with pytest.raises(pkg.S3Error):
        s3.put_object("nope", "x", b"1")
    assert s3.get_object("nope", "x") is None


def test_put_object_stream_multipart_and_open(pkg, server):
    """A streamed PUT above the part size goes up in parts and reads back
    byte for byte, also through short streamed reads; a small one is a
    plain PUT."""
    s3 = pkg.S3ObjectStore(server)
    s3.create_bucket("mp")
    s3._PART_SIZE = 1024
    payload = bytes(range(256)) * 40  # 10 parts

    def writer(f):
        for i in range(0, len(payload), 700):
            f.write(payload[i:i + 700])

    s3.put_object_stream("mp", "big.bin", writer)
    assert s3.get_object("mp", "big.bin") == payload
    with s3.open_object("mp", "big.bin") as f:
        got = b""
        while True:
            b = f.read(333)
            if not b:
                break
            got += b
    assert got == payload
    s3.put_object_stream("mp", "small.bin", lambda f: f.write(b"tiny"))
    assert s3.get_object("mp", "small.bin") == b"tiny"
    assert s3.open_object("mp", "missing.bin") is None


def test_local_put_object_stream_roundtrip(pkg, tmp_path):
    store = pkg.LocalObjectStore(str(tmp_path / "os"))
    store.create_bucket("b", versioning=True)
    store.put_object_stream("b", "x", lambda f: f.write(b"one"))
    store.put_object_stream("b", "x", lambda f: (f.write(b"tw"), f.write(b"o")))
    assert store.get_object("b", "x") == b"two"
    assert store.list_versions("b", "x") == [1]
    with store.open_object("b", "x") as f:
        assert f.read() == b"two"
    assert store.open_object("b", "nope") is None


def _docs_schema(pkg):
    s = pkg.schema
    return s.CollectionSchema(
        name="docs", dim=16, quantization=pkg.Quantization.F16, versioning=True,
        fields=[s.FieldSchema("pk", s.FieldType.STRING, primary_key=True),
                s.FieldSchema("lang", s.FieldType.STRING)])


def _fill(engine, vecs):
    engine.index_many("docs", [{"pk": f"p{i}", "lang": ["ko", "en"][i % 2]}
                               for i in range(len(vecs))], vecs)


def test_edge_checkpoint_roundtrip_through_network_client(pkg, server):
    """Create, ingest and flush on one engine; a fresh engine on the same
    S3 service discovers the collection, loads it and finds the rows;
    flushing twice more keeps two versions."""
    vecs = np.random.default_rng(0).standard_normal((32, 16)).astype(np.float32)
    store = pkg.S3ObjectStore(server)
    eng = pkg.engine(store)
    eng.create_collection(_docs_schema(pkg))
    _fill(eng, vecs)
    eng.flush("docs")
    eng2 = pkg.engine(pkg.S3ObjectStore(server))
    assert eng2.state.exists("docs")
    eng2.load_collection("docs")
    hits = eng2.search("docs", vecs[7], limit=3)
    assert hits[0].id == "p7" and hits[0].score > 99.0
    assert hits[0].metadata["lang"] == "en"
    eng2.flush("docs")
    eng2.flush("docs")
    assert len(store.list_versions("docs", "docs.vertex")) <= 2


@pytest.mark.parametrize("writer", PKGS)
def test_edge_checkpoint_crosses_packages_through_s3(server, writer):
    """One package's engine flushes through its S3 client; the other
    package's engine, through its own client, loads the collection and
    answers as the writer does (f16 codes: scores within 1e-3)."""
    reader = PKGS[1 - PKGS.index(writer)]
    wp, rp = _pkg(writer), _pkg(reader)
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    queries = rng.standard_normal((5, 16)).astype(np.float16).astype(np.float32)
    w = wp.engine(wp.S3ObjectStore(server))
    w.create_collection(_docs_schema(wp))
    _fill(w, vecs)
    w.index("docs", {"pk": "p4"}, delete=True)
    w.flush("docs")
    r = rp.engine(rp.S3ObjectStore(server))
    r.load_collection("docs")
    assert r.get_collection("docs")["size"] == 299
    for q in queries:
        want, got = w.search("docs", q, limit=8), r.search("docs", q, limit=8)
        assert [h.id for h in got] == [h.id for h in want]
        np.testing.assert_allclose([h.score for h in got], [h.score for h in want],
                                   atol=1e-3)
        assert all(h.metadata == wh.metadata for h, wh in zip(got, want))


def test_server_built_with_s3_object_store(server, tmp_path):
    """``[storage] object_store = "s3"`` builds both object-store modes of
    the port on the S3 client; an edge collection flushed by one servicer
    is found and served by a new one."""
    from coltt_tpu_torch.api.server import build_servicer
    from coltt_tpu_torch.storage.s3 import S3ObjectStore
    from coltt_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.serving.device = "cpu"
    cfg.serving.precompile_batches = ""
    cfg.storage.object_store = "s3"
    cfg.storage.s3_endpoint = server
    exp = build_servicer("experimental", cfg).engine
    assert isinstance(exp.objects, S3ObjectStore)
    eng = build_servicer("edge", cfg).engine
    assert isinstance(eng.objects, S3ObjectStore)
    port = _pkg("coltt_tpu_torch")
    vecs = np.random.default_rng(2).standard_normal((40, 16)).astype(np.float32)
    eng.create_collection(_docs_schema(port))
    _fill(eng, vecs)
    eng.close()
    again = build_servicer("edge", cfg).engine
    again.load_collection("docs")
    assert again.search("docs", vecs[11], limit=1)[0].id == "p11"

"""The core (``root``) mode of the port end to end: its gRPC server and
client over localhost (the core flows of ``test_api.py``) on CPU tensors,
and ``python -m coltt_tpu_torch --mode root`` as a process."""

import os
import signal
import socket
import subprocess
import sys

import grpc
import numpy as np
import pytest
import torch

from coltt_tpu_torch.api.client import CoreClient
from coltt_tpu_torch.api.server import build_servicer, create_server
from coltt_tpu_torch.store.hnsw import HnswConfig
from coltt_tpu_torch.utils.config import Config

DIM = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(tmp_path) -> Config:
    cfg = Config()
    cfg.root_layer.bind_address = "127.0.0.1:0"
    cfg.storage.data_dir = str(tmp_path / "data")
    cfg.serving.device = "cpu"
    return cfg


@pytest.fixture
def core(tmp_path):
    cfg = _config(tmp_path)
    servicer = build_servicer("root", cfg)
    server = create_server(servicer, cfg)
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{server.bound_port}")
    yield CoreClient(channel)
    channel.close()
    server.stop(None)
    servicer.engine.kv.close()


def test_core_full_flow(core, rng):
    assert core.ping()
    core.create_collection("c", DIM)
    vecs = rng.standard_normal((15, DIM), dtype=np.float32)
    for i in range(15):
        core.insert("c", vecs[i], {"tag": f"t{i % 3}"}, ext_id=f"id{i}")
    info = core.collection_info("c")
    assert info.info.collection_length == 15
    assert info.info.collection_config.m == 16

    hits, latency = core.vector_search("c", vecs[4], top_k=3, with_latency=True)
    assert hits[0]["id"] == "id4"
    assert latency.endswith("ms")

    hits, _ = core.filter_search("c", {"tag": "t1"}, top_k=20, vector=vecs[1])
    assert hits and all(h["metadata"]["tag"] == "t1" for h in hits)

    hits, _ = core.hybrid_search("c", vecs[2], {"tag": "t2"}, top_k=5)
    assert hits[0]["id"] == "id2"

    core.update("c", "id4", vecs[0] * 2, {"tag": "changed"})
    hits, _ = core.vector_search("c", vecs[0] * 2, top_k=1)
    assert hits[0]["id"] in ("id4", "id0")  # colinear with id0 on cosine

    core.delete("c", "id5")
    assert core.collection_info("c").info.collection_length == 14

    assert core.compare_dist([1, 0], [1, 0]) == pytest.approx(100.0)

    core.release_collection("c")
    core.load_collection("c")
    hits, _ = core.vector_search("c", vecs[7], top_k=1)
    assert hits[0]["id"] == "id7"
    core.drop_collection("c")


def test_core_config_round_trip(core):
    cfg = HnswConfig(m=12, ef=40, ef_construction=90, algorithm="heuristic",
                     heuristic_keep_pruned=False)
    core.create_collection("h", DIM, metric=1, config=cfg)
    got = core.collection_info("h").info
    assert got.distance == 1
    c = got.collection_config
    assert (c.m, c.m_max, c.m_max0, c.ef, c.ef_construction) == (12, 12, 24, 40, 90)
    assert c.search_algorithm == 1 and not c.heuristic_keep_pruned


def test_core_vector_search_batch_rpc(core, rng):
    core.create_collection("c", DIM)
    vecs = rng.standard_normal((30, DIM), dtype=np.float32)
    core.bulk_insert("c", vecs, [{"tag": f"t{i % 3}"} for i in range(30)],
                     ext_ids=[f"id{i}" for i in range(30)])
    counts, scores, rids, mds, latency = core.vector_search_batch(
        "c", vecs[:6], top_k=3, include_metadata=True, with_latency=True)
    assert len(counts) == 6 and latency.endswith("ms")
    off = 0
    for q in range(6):
        assert rids[off] == f"id{q}"
        assert mds[off]["tag"] == f"t{q % 3}"
        # VectorSearch equals its batch row
        hits, _ = core.vector_search("c", vecs[q], top_k=3)
        assert [h["id"] for h in hits] == rids[off:off + counts[q]]
        assert [h["score"] for h in hits] == pytest.approx(scores[off:off + counts[q]])
        off += counts[q]


def test_core_bulk_insert_rpc(core, rng):
    core.create_collection("b", DIM)
    vecs = rng.standard_normal((120, DIM), dtype=np.float32)
    mds = [{"tag": f"t{i % 2}"} for i in range(120)]
    ids = core.bulk_insert("b", vecs, mds, ext_ids=[f"bk{i}" for i in range(120)])
    assert len(ids) == 120 and ids[3] == "bk3"
    assert core.collection_info("b").info.collection_length == 120
    hits, _ = core.vector_search("b", vecs[11], top_k=1)
    assert hits[0]["id"] == "bk11"
    hits, _ = core.hybrid_search("b", vecs[10], {"tag": "t0"}, top_k=3)
    assert hits[0]["id"] == "bk10"
    auto_ids = core.bulk_insert("b", rng.standard_normal((3, DIM), dtype=np.float32))
    assert len(auto_ids) == 3 and all(auto_ids)


def test_core_errors_are_responses(core, rng):
    with pytest.raises(RuntimeError, match="not exist|unknown|not found|loaded"):
        core.vector_search("ghost", np.zeros(DIM), top_k=1)
    core.create_collection("c", DIM)
    with pytest.raises(RuntimeError, match="dimension"):
        core.insert("c", np.zeros(DIM + 1), {})


def test_root_mode_without_cuda_raises(tmp_path, monkeypatch):
    """``[serving].device`` defaults to CUDA: the core mode refuses to start
    without it rather than serving from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(tmp_path)
    cfg.serving.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        build_servicer("root", cfg)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_serves_root_mode(tmp_path, rng):
    """``python -m coltt_tpu_torch --mode root`` serves, and stops on
    SIGTERM after snapshotting its loaded collections."""
    port = _free_port()
    (tmp_path / "coltt.toml").write_text(
        f'[root_layer]\nbind_address = "127.0.0.1:{port}"\n'
        f'prof_address = "127.0.0.1:{_free_port()}"\n'
        f'[storage]\ndata_dir = "{tmp_path / "data"}"\n'
        f'[serving]\ndevice = "cpu"\n')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    proc = subprocess.Popen(
        [sys.executable, "-m", "coltt_tpu_torch", "--mode", "root",
         "--config", str(tmp_path / "coltt.toml")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        grpc.channel_ready_future(channel).result(timeout=120)
        c = CoreClient(channel)
        c.create_collection("m", DIM)
        vecs = rng.standard_normal((5, DIM), dtype=np.float32)
        for i, v in enumerate(vecs):
            c.insert("m", v, {}, ext_id=f"m{i}")
        assert c.vector_search("m", vecs[3], top_k=1)[0][0]["id"] == "m3"
        channel.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out.decode()[-2000:]
    assert (tmp_path / "data" / "m.raw").exists()  # snapshotted on the way down

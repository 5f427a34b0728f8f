"""Two real processes search one corpus over ``torch.distributed`` (gloo).

The port's counterpart of ``tests/test_distributed.py``: two OS processes
(``tests/torch_distributed_worker.py``), each with 4 ``cpu`` shards, join
a gloo process group on localhost; each places only its own rows
(``assemble_global_rows``) and the dense, PQ, CFLAT and unit-i8
searches merge their partials across the process boundary. Each worker checks its
results against a numpy exact scan and the one-process port search.
Every worker runs under a 120 s timeout and joins the group under a 60 s
one, so a hang fails the test instead of stalling the suite.
"""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "torch_distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_search():
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [subprocess.Popen([sys.executable, _WORKER, coordinator, "2", str(pid)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"OK-{pid}" in out, f"worker {pid} gave no OK:\n{out}"


def test_init_distributed_without_devices_needs_a_card(monkeypatch):
    """Without ``devices=`` the process's devices are every visible card,
    and where torch sees none, joining fails before any rendezvous store
    is opened: host shards are asked for by name, never picked."""
    import torch
    import torch.distributed as dist

    from coltt_tpu_torch.parallel import multihost

    def no_store(*a, **kw):
        raise AssertionError("a store was opened")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(dist, "TCPStore", no_store)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1,
                                   process_id=0)
    assert not dist.is_initialized()

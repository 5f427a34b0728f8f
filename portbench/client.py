"""The load: closed-loop clients in processes of their own.

Each client process (spawned, so that its Python work never takes the
server's interpreter lock) runs ``per_process`` client threads over one
gRPC channel. A client sends its next request only when the previous reply
has been decoded, and cycles through its own offset of the query pool.
The wire messages come from the generated protobuf classes
(``portbench/rpcs/<RPC>.py``); nothing of the program's client is used.

A request's latency runs from the call (the request object is built
before) to a decoded reply, on ``time.monotonic`` (one clock for every
process of the machine). Each client keeps a uniform sample of the
answers it got (reservoir sampling from a generator seeded with the run's
seed and the client's number) for the check of the answers.

This module imports neither torch nor the program: a client process
starts in about a second.
"""

from __future__ import annotations

import importlib.util
import multiprocessing as mp
import os
import sys
import threading
import time

import numpy as np

CALL_GRACE_S = 60.0  # a reply may come this long after the window closes
MAX_MESSAGE = 64 << 20


def load_rpc(name: str, repo: str):
    """``<repo>/portbench/rpcs/<name>.py`` as a module."""
    path = os.path.join(repo, "portbench", "rpcs", f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no RPC builder {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_rpc_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Reservoir:
    """A uniform sample of at most ``cap`` answers, each ``(pool index,
    hit count, row ids [k], scores [k])``; the row id of a hit is its
    primary key read as a row number (-2 where it is not one)."""

    def __init__(self, cap: int, k: int, rng: np.random.Generator):
        self.cap, self.k, self.rng, self.seen = cap, k, rng, 0
        self.pool = np.full(cap, -1, np.int64)
        self.count = np.zeros(cap, np.int32)
        self.ids = np.full((cap, k), -1, np.int64)
        self.scores = np.full((cap, k), np.nan, np.float32)

    @staticmethod
    def _row(pk) -> int:
        return int(pk) if isinstance(pk, str) and pk.isdigit() else -2

    def offer(self, pool_idx, counts, ids, scores) -> None:
        """Offer one reply's answers: ``pool_idx [n]``, ``counts [n]`` and
        the flat ``ids`` / ``scores`` of its hits in query order."""
        n = len(pool_idx)
        g = self.seen + np.arange(n)
        slot = np.where(g < self.cap, g, self.rng.integers(0, g + 1))
        self.seen += n
        take = np.nonzero(slot < self.cap)[0]
        if take.size == 0:
            return
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for j in take:
            s, c = int(slot[j]), int(counts[j])
            lo = int(starts[j])
            kept = min(c, self.k)
            self.pool[s] = pool_idx[j]
            self.count[s] = c
            self.ids[s] = -1
            self.scores[s] = np.nan
            self.ids[s, :kept] = [self._row(p) for p in ids[lo:lo + kept]]
            self.scores[s, :kept] = scores[lo:lo + kept]

    def arrays(self) -> dict:
        n = min(self.seen, self.cap)
        return {"pool": self.pool[:n], "count": self.count[:n],
                "ids": self.ids[:n], "scores": self.scores[:n]}


def _client_thread(cid, plan, pool, call, rpc, out, start, barrier):
    try:
        _client_loop(cid, plan, pool, call, rpc, out, start, barrier)
    except Exception as e:  # noqa: BLE001 — reported to the harness
        out.setdefault("errors", []).append(f"client {cid}: {type(e).__name__}: {e}")


def _client_loop(cid, plan, pool, call, rpc, out, start, barrier):
    traffic = plan["traffic"]
    nq = int(traffic.get("batch", 1))
    n_pool = pool.shape[0]
    offset = (cid * n_pool) // plan["clients"]
    k = int(traffic["k"])
    res = Reservoir(plan["sample_per_client"], k,
                    np.random.default_rng([plan["seed"] % (1 << 63), cid]))
    timeout = plan["seconds"] + CALL_GRACE_S
    trace = plan["trace"]

    sent, done, nqs, oks, reqs = [], [], [], [], []
    seq = 0

    def one(record: bool):
        nonlocal offset, seq
        idx = (offset + np.arange(nq)) % n_pool
        offset = (offset + nq) % n_pool
        req = rpc.build(plan["collection"], pool[idx], traffic, trace)
        tag = f"{cid}.{seq}"
        seq += 1
        md = (("x-portbench-req", tag),) if trace else None
        t_send = time.monotonic()
        try:
            reply = rpc.decode(call(req, timeout=timeout, metadata=md))
        except Exception as e:  # noqa: BLE001 — a failed call is a result
            reply = None
            if record:
                out.setdefault("errors", []).append(f"{type(e).__name__}: {e}"[:300])
        t_done = time.monotonic()
        if not record:
            return
        ok = reply is not None and reply["ok"]
        sent.append(t_send)
        done.append(t_done)
        nqs.append(nq)
        oks.append(ok)
        reqs.append(tag)
        if ok:
            res.offer(idx, reply["counts"], reply["ids"], reply["scores"])
        elif reply is not None and len(out.get("errors", [])) < 20:
            out.setdefault("errors", []).append(reply.get("error", "status false"))

    try:
        for _ in range(int(traffic.get("warmup_requests", 2))):
            one(record=False)
    finally:
        barrier.wait()
    start["go"].wait()
    t0, t1 = start["window"]
    time.sleep(max(0.0, t0 - time.monotonic()))
    while time.monotonic() < t1:
        one(record=True)
    out.update({
        "sent": np.asarray(sent, np.float64), "done": np.asarray(done, np.float64),
        "nq": np.asarray(nqs, np.int64), "ok": np.asarray(oks, bool),
        "req": reqs,
        "sample": res.arrays(),
    })


def client_process(conn, plan: dict) -> None:
    """Body of one client process: connect, warm up, report ready, wait
    for the window, run it, send the records back."""
    sys.path.insert(0, plan["gen_dir"])
    import grpc

    rpc = load_rpc(plan["traffic"]["rpc"], plan["repo"])
    pool = np.load(plan["pool_path"])
    channel = grpc.insecure_channel(
        plan["address"],
        options=[("grpc.max_receive_message_length", MAX_MESSAGE),
                 ("grpc.max_send_message_length", MAX_MESSAGE)])
    call = channel.unary_unary(
        f"/{rpc.SERVICE}/{rpc.NAME}",
        request_serializer=rpc.request_class().SerializeToString,
        response_deserializer=rpc.response_class().FromString)
    cids = plan["client_ids"]
    outs = [{} for _ in cids]
    start: dict = {"go": threading.Event()}
    barrier = threading.Barrier(len(cids) + 1)
    threads = [threading.Thread(
        target=_client_thread,
        args=(cid, plan, pool, call, rpc, out, start, barrier), daemon=True)
        for cid, out in zip(cids, outs)]
    for t in threads:
        t.start()
    barrier.wait()  # every client has warmed up
    conn.send("ready")
    start["window"] = conn.recv()
    start["go"].set()
    for t in threads:
        t.join()
    channel.close()
    conn.send(outs)
    conn.close()


class ClientPool:
    """The client processes of a run: ``clients`` closed-loop clients in
    ``processes`` spawned processes (``plan`` is what every process gets,
    plus its client numbers)."""

    def __init__(self, plan: dict, processes: int, clients: int):
        if processes < 1 or clients % processes:
            raise ValueError(f"{clients} clients do not spread evenly over "
                             f"{processes} processes")
        ctx = mp.get_context("spawn")
        per = clients // processes
        self.procs, self.conns = [], []
        for p in range(processes):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=client_process, daemon=True,
                args=(child, dict(plan, clients=clients,
                                  client_ids=list(range(p * per, (p + 1) * per)))))
            proc.start()
            child.close()
            self.procs.append(proc)
            self.conns.append(parent)

    def wait_ready(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        for conn, proc in zip(self.conns, self.procs):
            if not conn.poll(max(0.0, deadline - time.monotonic())):
                raise RuntimeError(f"client process {proc.pid} not ready "
                                   f"after {timeout} s")
            msg = conn.recv()
            if msg != "ready":
                raise RuntimeError(f"client process {proc.pid}: {msg!r}")

    def start(self, t0: float, t1: float) -> None:
        for conn in self.conns:
            conn.send((t0, t1))

    def collect(self, timeout: float) -> list:
        """Every client's records (waiting at most ``timeout`` s), then the
        processes joined."""
        deadline = time.monotonic() + timeout
        outs = []
        for conn, proc in zip(self.conns, self.procs):
            if not conn.poll(max(0.0, deadline - time.monotonic())):
                raise RuntimeError(f"client process {proc.pid} sent no records")
            outs.extend(conn.recv())
        self.close()
        return outs

    def close(self) -> None:
        for proc in self.procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
        for conn in self.conns:
            conn.close()

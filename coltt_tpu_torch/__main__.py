"""Process entry: ``python -m coltt_tpu_torch --config coltt.toml``.

Serves the edge mode (quantized FLAT collections behind gRPC), the core
mode (``root``: HNSW collections with a WAL-backed KV commit log under
``[storage] data_dir``) or the experimental mode (CFLAT multi-vector
collections) on the torch device named by ``[serving] device`` (default
``"cuda"``; the engines raise if CUDA is asked for and absent). Port of
``coltt_tpu/__main__.py`` (reference parity: ``cmd/root/main.go:38-90`` —
parse the mode, create the data directory, start the profiling endpoint
and the service layer, then block until SIGINT/SIGTERM and stop gracefully
with a 10 s grace, flushing every loaded collection on the way down).
"""

from __future__ import annotations

import argparse
import gc
import http.server
import json
import os
import signal
import sys
import threading
import traceback

from coltt_tpu_torch.utils import trace
from coltt_tpu_torch.utils.config import load_config
from coltt_tpu_torch.utils.logging import get_logger

log = get_logger("main")


def _start_prof_server(addr: str):
    """pprof-equivalent: a tiny HTTP endpoint exposing thread stacks
    (net/http/pprof parity, cmd/root/main.go:61-75) at ``/``, and at
    ``/debug/trace`` the served path's spans and counters as JSON
    (``utils/trace.py`` ``summary``). Returns the HTTP server, or None
    where the address cannot be bound."""
    host, _, port = addr.rpartition(":")

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/debug/trace":
                body = json.dumps(trace.summary()).encode()
                ctype = "application/json"
            else:
                frames = sys._current_frames()
                body = "".join(
                    f"--- thread {tid} ---\n" + "".join(traceback.format_stack(frame))
                    for tid, frame in frames.items()
                ).encode()
                ctype = "text/plain"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    try:
        server = http.server.ThreadingHTTPServer((host or "0.0.0.0", int(port)), Handler)
    except OSError as e:
        log.warning(f"prof server unavailable: {e}")
        return None
    threading.Thread(target=server.serve_forever, daemon=True).start()
    log.info("prof server listening", extra={"kv": {"addr": addr}})
    return server


def main() -> None:
    parser = argparse.ArgumentParser("coltt-tpu-torch")
    parser.add_argument(
        "-mode", "--mode", default=None,
        help="root (HNSW + commit log), edge (quantized FLAT) or "
             "experimental (CFLAT multi-vector)",
    )
    parser.add_argument("--config", default="coltt.toml")
    parser.add_argument("--bind", default=None, help="override bind address")
    args = parser.parse_args()

    cfg = load_config(args.config)
    if args.mode:
        cfg.mode = args.mode
    if args.bind:
        cfg.root_layer.bind_address = args.bind

    os.makedirs(cfg.storage.data_dir, exist_ok=True)
    _start_prof_server(cfg.root_layer.prof_address)

    import torch

    from coltt_tpu_torch.api.server import build_servicer, create_server

    device = torch.device(cfg.serving.device)
    if device.type == "cuda":
        log.info("device", extra={"kv": {
            "device": str(device), "name": torch.cuda.get_device_name(device)}})
    # the edge engine builds the CUDA kernels at construction, before the
    # listener opens: a server that is ready when it says it is (the
    # experimental engine has no kernel of its own)
    servicer = build_servicer(cfg.mode, cfg)
    server = create_server(servicer, cfg)
    # freeze the boot-time object graph out of the cyclic GC before the
    # listener starts (gen-2 sweeps over a loaded engine land on request
    # latencies; frozen objects are never scanned again)
    gc.collect()
    gc.freeze()
    server.start()
    log.info(
        "server started",
        extra={"kv": {"mode": cfg.mode, "addr": cfg.root_layer.bind_address}},
    )

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()

    log.info("shutting down (grace 10s)")
    server.stop(grace=10).wait(timeout=10)
    servicer.engine.close()  # flush loaded collections
    log.info("bye")


if __name__ == "__main__":
    main()

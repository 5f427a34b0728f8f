"""On the card: the traced window's device clock is aligned to the host's,
and kernels launched from other threads (the server's handlers) are kept.

Run there with ``python -m pytest portbench/tests -m cuda``; it skips
where there is no CUDA device."""

import threading
import time

import pytest


@pytest.mark.cuda
def test_device_events_land_on_the_host_clock():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.trace import DeviceTrace, busy_intervals

    a = torch.randn(4096, 4096, device="cuda")
    (a @ a).sum().item()
    dt = DeviceTrace()
    dt.start()
    time.sleep(0.05)
    h0 = time.monotonic()
    for _ in range(20):
        a = (a @ a) / 64.0
    torch.cuda.synchronize()
    h1 = time.monotonic()
    time.sleep(0.05)
    dt.stop()
    ev = dt.events(dt.t_start, dt.t_end)
    gemms = [e for e in ev["device"] if "gemm" in e[0].lower() or "sm90" in e[0]]
    assert len(gemms) >= 20
    first, last = min(e[1] for e in gemms), max(e[2] for e in gemms)
    assert h0 - 1e-3 <= first and last <= h1 + 1e-3
    busy = sum(b - a for a, b in busy_intervals(ev["device"], ev["start"], ev["end"]))
    assert 0 < busy < ev["end"] - ev["start"]


@pytest.mark.cuda
def test_kernels_of_worker_threads_are_kept():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.trace import DeviceTrace

    stop, launched = threading.Event(), []
    pool_ready = threading.Barrier(3)

    def worker():
        y = torch.randn(256, 256, device="cuda")
        pool_ready.wait()
        while not stop.is_set():
            torch.mm(y, y)
            torch.cuda.synchronize()
            launched.append(time.monotonic())
            time.sleep(0.001)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    pool_ready.wait()
    dt = DeviceTrace()
    dt.start()
    time.sleep(0.5)
    dt.stop()
    stop.set()
    for t in threads:
        t.join()
    ev = dt.events(dt.t_start, dt.t_end)
    inside = sum(1 for t in launched if dt.t_start <= t <= dt.t_end)
    assert inside > 50
    assert sum(1 for e in ev["device"] if "spin_kernel" not in e[0]) >= inside // 2

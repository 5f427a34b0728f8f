"""The device trace's clock alignment: each marker kernel the profiler
kept is told by its length and sets the offset; a lost marker leaves the
other to align on, and a session with none has no device to report."""

import pytest

from portbench.trace import align

OFF = 7_000_000_000  # device clock ahead of the host's by 7 s
MARKS = [(10.0, 10.001), (15.0, 15.003)]


def _start_marker():
    return ("spin_kernel", 10.0002e9 + OFF, 10.0008e9 + OFF)   # 0.6 ms


def _end_marker():
    return ("spin_kernel", 15.0002e9 + OFF, 15.0025e9 + OFF)   # 2.3 ms


KERNEL = ("binmax_scan_s8_kernel", 12.0e9 + OFF, 12.003e9 + OFF)


@pytest.mark.parametrize("kept", [("start", "end"), ("start",), ("end",)])
def test_align_on_the_markers_kept(kept):
    raw = [KERNEL] + [{"start": _start_marker(), "end": _end_marker()}[k]
                      for k in kept]
    dev = align(raw, MARKS)
    assert [d[0] for d in dev] == ["binmax_scan_s8_kernel"]
    assert dev[0][1] == pytest.approx(12.0, abs=1e-3)
    assert dev[0][2] - dev[0][1] == pytest.approx(0.003, abs=1e-9)


@pytest.mark.parametrize("raw", [[KERNEL], [KERNEL, _start_marker(), _start_marker()]])
def test_no_usable_marker_raises(raw):
    with pytest.raises(RuntimeError):
        align(raw, MARKS)

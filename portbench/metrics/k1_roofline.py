"""Kernel K1, its int8 loop (``csrc/binmax_scan.cu``
``binmax_scan_s8_kernel``): the least time of a launch (the larger of
2*Qp*N*D operations at the int8 peak and its bytes at the memory rate,
``roofline.py``, from the shapes of the launches in the traced
sub-window) over the kernel's mean device time there, in %."""

import numpy as np

from portbench.reduce import profile_window
from portbench.roofline import k1_int8_bound_s


def read(rec):
    w = profile_window(rec)
    if w is None:
        return None
    dev, lo, hi = w
    times = [t - s for n, s, t in dev
             if "binmax_scan_s8_kernel" in n and lo <= s and t <= hi]
    calls = [c for c in rec["k1_calls"] if lo <= c[0] <= hi and c[4] == "int8"]
    if not times or not calls:
        return None
    bound = np.mean([k1_int8_bound_s(qp, n, d) for _, qp, n, d, _ in calls])
    return 100.0 * bound / float(np.mean(times))

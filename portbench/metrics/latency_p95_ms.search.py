"""The whole request path of Search, client to decoded reply: the 95th
percentile of every answered request's latency in the traced run, in ms.
It stands per layer where one-query latency spreads too widely between
runs for an end-to-end bound."""

import numpy as np


def read(rec):
    if rec["rpc"] != "Search":
        return None
    r = rec["requests"]
    lat = (r["done"] - r["sent"])[r["ok"]]
    return float(np.percentile(lat, 95) * 1e3) if lat.size else None

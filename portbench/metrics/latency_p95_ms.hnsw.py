"""The whole request path of core VectorSearchBatch, client to decoded
reply: the 95th percentile of every answered request's latency in the
traced run, in ms. It stands per layer beside the cell's ``qps``."""

import numpy as np


def read(rec):
    if rec["rpc"] != "VectorSearchBatch":
        return None
    r = rec["requests"]
    lat = (r["done"] - r["sent"])[r["ok"]]
    return float(np.percentile(lat, 95) * 1e3) if lat.size else None

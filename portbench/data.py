"""A configuration's rows and query pool, made on the device from the seed.

The recipes are frozen copies, so that the yardstick does not move when
the program changes:

- :func:`mixture_rows` is ``coltt_tpu_torch/bench.py`` ``mixture_rows``:
  a uniformly drawn centre plus ``sigma`` times gaussian noise;
- :func:`make_rows` is ``coltt_tpu_torch/bench_hnsw.py`` ``make_corpus``
  (``centers`` gaussian centres, then the mixture), made in slabs of
  ``SLAB`` rows so that a million wide rows never need their transients
  at once.

The rows come from one ``torch.Generator`` seeded with the run's seed and
the query pool from a second one, on the device the generators live on,
so the same seed gives the same rows and queries on any run.
"""

from __future__ import annotations

import numpy as np
import torch

SLAB = 1 << 18
_QUERY_STREAM = 0x9E3779B97F4A7C15  # separates the pool's stream from the rows'


def mixture_rows(gen: torch.Generator, centers: torch.Tensor, n: int,
                 sigma: float) -> torch.Tensor:
    """``n`` rows of the cluster mixture on ``gen``'s device."""
    asg = torch.randint(0, centers.shape[0], (n,), generator=gen, device=gen.device)
    noise = torch.randn((n, centers.shape[1]), generator=gen, device=gen.device)
    return centers[asg] + sigma * noise


def generators(seed: int, device) -> tuple[torch.Generator, torch.Generator]:
    """The rows' and the query pool's generators for ``seed``."""
    g_rows = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    g_pool = torch.Generator(device=device).manual_seed(
        (seed ^ _QUERY_STREAM) % (1 << 63))
    return g_rows, g_pool


def make_rows(recipe: dict, rows: int, dim: int, seed: int, device):
    """``(rows [rows, dim] f32 on the host, pool [pool, dim] f32 on the
    host)`` of ``recipe`` (``{"centers": C, "sigma": s}``) and
    ``recipe["pool"]`` queries of the same mixture."""
    g_rows, g_pool = generators(seed, device)
    centers = torch.randn((int(recipe["centers"]), dim), generator=g_rows,
                          device=device)
    sigma = float(recipe["sigma"])
    out = np.empty((rows, dim), np.float32)
    for lo in range(0, rows, SLAB):
        n = min(SLAB, rows - lo)
        out[lo:lo + n] = mixture_rows(g_rows, centers, n, sigma).cpu().numpy()
    pool = mixture_rows(g_pool, centers, int(recipe["pool"]), sigma).cpu().numpy()
    return out, pool

"""The plain reference the served answers are judged against, and the
lower-precision controls that have to fail that judgement.

Plain PyTorch: it imports nothing of the program. Everything the program
derives from the rows (codes, scales, norms, the graph) is worked out
again here from the same host rows.

- :func:`exact_topk`: the exact top-k of each query by an f32 scan of the
  rows in blocks (TF32 off), on the 0-100 score scale;
- :func:`pair_scores`: the exact score of given (query, row) pairs, in
  float64;
- :func:`normalize_score`: the 0-100 mapping, a frozen copy of
  ``coltt_tpu_torch/ops/score.py`` (cosine ``((2 - d) / 2) * 100`` with
  ``d = 1 - cos``; euclidean ``max(0, 100 - d)`` with ``d`` the squared
  distance);
- :func:`control_topk`: a control put in the program's place: the same
  scan in the precision just below the configuration's (``int4`` codes
  for int8 ones, ``tf32`` operands for f32), or the exact scan of the
  rows less a seeded tenth of them (``drop10``: a search that never
  reaches part of the collection, such as a cut-off graph region or a
  lost shard; its scores are exact, so only its rows can fail it).

Rows are ranked by their distance (cosine: by the 0-100 score, which is
monotonic in it): the euclidean score ``max(0, 100 - d)`` ties every row
at ``d >= 100``, so it is mapped only for the scores returned.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 1 << 17
_DROP_STREAM = 0xD10  # separates drop10's rows from the run's other draws


def normalize_score(dist: torch.Tensor, metric: str) -> torch.Tensor:
    """Distance -> similarity on the 0-100 scale (``ops/score.py``)."""
    if metric == "cosine":
        return ((2.0 - dist) / 2.0) * 100.0
    return torch.clamp(100.0 - dist, min=0.0)


def _keys(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """[Q, B] ranking keys of queries against a block of rows, higher is
    nearer, in the operands' precision (no TF32: the caller's settings
    hold): cosine the 0-100 score, euclidean ``-d``."""
    if metric == "cosine":
        qn = q / q.norm(dim=1, keepdim=True).clamp(min=1e-30)
        xn = x / x.norm(dim=1, keepdim=True).clamp(min=1e-30)
        return normalize_score(1.0 - qn @ xn.t(), metric)
    d = (q * q).sum(1, keepdim=True) + (x * x).sum(1)[None, :] - 2.0 * (q @ x.t())
    return -d.clamp(min=0.0)


def _key_scores(keys: torch.Tensor, metric: str) -> torch.Tensor:
    """Ranking keys -> the 0-100 scores."""
    return keys if metric == "cosine" else normalize_score(-keys, metric)


def _scan(queries: np.ndarray, rows: np.ndarray, k: int, metric: str, device,
          prepare=lambda t: t, reach: np.ndarray | None = None):
    """``(0-100 scores, row ids)`` of the exact top-k by the ranking keys
    of ``prepare``d operands, rows in blocks; rows where the bool mask
    ``reach`` is False are never returned."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        q = prepare(torch.from_numpy(np.ascontiguousarray(queries)).to(device))
        best_s = best_i = None
        for lo in range(0, rows.shape[0], BLOCK_ROWS):
            x = prepare(torch.from_numpy(rows[lo:lo + BLOCK_ROWS]).to(device))
            s = _keys(q, x, metric)
            if reach is not None:
                out = torch.from_numpy(~reach[lo:lo + BLOCK_ROWS]).to(device)
                s[:, out] = -torch.inf
            v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
            i = i + lo
            if best_s is not None:
                v, sel = torch.topk(torch.cat([best_s, v], 1), k, dim=1)
                i = torch.gather(torch.cat([best_i, i], 1), 1, sel)
            best_s, best_i = v, i
        return _key_scores(best_s, metric).cpu().numpy(), best_i.cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def exact_topk(queries: np.ndarray, rows: np.ndarray, k: int, metric: str,
               device) -> tuple[np.ndarray, np.ndarray]:
    """``(scores [Q, k] f32, row ids [Q, k])`` of the exact f32 scan."""
    return _scan(queries, rows, k, metric, device)


def pair_scores(queries: np.ndarray, rows: np.ndarray, qi: np.ndarray,
                ri: np.ndarray, metric: str, device,
                chunk: int = 1 << 16) -> np.ndarray:
    """float64 0-100 scores of the pairs ``(queries[qi[j]], rows[ri[j]])``."""
    out = np.empty(len(qi), np.float64)
    for lo in range(0, len(qi), chunk):
        q = torch.from_numpy(queries[qi[lo:lo + chunk]]).to(device, torch.float64)
        x = torch.from_numpy(rows[ri[lo:lo + chunk]]).to(device, torch.float64)
        if metric == "cosine":
            cos = (q * x).sum(1) / (q.norm(dim=1) * x.norm(dim=1)).clamp(min=1e-300)
            d = 1.0 - cos
        else:
            d = ((q - x) ** 2).sum(1)
        out[lo:lo + chunk] = normalize_score(d, metric).cpu().numpy()
    return out


def int4_codes(x: torch.Tensor) -> torch.Tensor:
    """Rows at 4 bits: ``round(x / s)`` clipped to +-7 with ``s = absmax / 7``
    a row, dequantized back to f32 (the int8 recipe with 7 for 127)."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    s = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    return torch.round(x / s).clamp(-7, 7) * s


def tf32_operands(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10-bit mantissa (round to nearest), as
    the tensor cores round their operands under TF32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


PRECISION = {"int4": int4_codes, "tf32": tf32_operands}
CONTROLS = (*PRECISION, "drop10")


def reached(n: int, seed: int) -> np.ndarray:
    """``drop10``'s rows: a bool mask ``[n]``, False at a tenth of them
    drawn from ``seed`` on a stream of their own."""
    rng = np.random.default_rng([seed % (1 << 63), _DROP_STREAM])
    mask = np.ones(n, bool)
    mask[rng.permutation(n)[:n // 10]] = False
    return mask


def control_topk(control: str, queries: np.ndarray, rows: np.ndarray, k: int,
                 metric: str, device, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The control ``control`` (one of ``CONTROLS``) in the program's
    place: ``(scores [Q, k], ids [Q, k])`` into ``rows``. ``drop10`` leaves
    out the same tenth of ``rows`` for every query."""
    if control == "drop10":
        return _scan(queries, rows, k, metric, device,
                     reach=reached(rows.shape[0], seed))
    return _scan(queries, rows, k, metric, device, prepare=PRECISION[control])

"""Product quantization: codebook training, encoding, ADC top-k search.

Port of ``coltt_tpu/ops/pq.py``. A codebook holds ``M`` subspaces of
``K`` centroids each (``[M, K, dsub]``), optionally an OPQ rotation
``[D, D]`` (every stored vector lives in the rotated space; dot and cosine
are rotation-invariant, so searches rotate the query once) and
optionally a whole-vector coarse quantizer ``[C, D]`` (residual mode: the
codes encode ``x - coarse[cid]`` and carry ``cid`` as two big-endian
leading bytes, so a code row is ``[2 + M]`` uint8).

- Training is batched Lloyd's iterations over all subspaces at once
  (assignment by one batched product, the update by ``index_add_``), with
  the OPQ alternation (PCA initialisation through numpy ``eigh``, then
  Procrustes through numpy ``svd``, on the host as the reference does)
  and the coarse residual quantizer. Samples and initial centroids are
  drawn from a ``torch.Generator``: no torch stream reproduces
  ``jax.random``, so training is held to the reference by quality, and
  everything after training by a codebook the reference trained
  (``PQCodebook.save`` / ``load`` are byte-compatible both ways).
- Encoding is the same batched assignment, blocked over rows.
- Search reconstructs a block of rows through the codebook gather
  (:func:`_reconstruct`) in ``compute_dtype`` and scans it with
  :func:`~coltt_tpu_torch.ops.distance.scan_distances` (ADC as a
  product), then merges block-local top-k partials.

Device work here is torch operations, as the reference's is XLA: no
Pallas kernel exists for it. Blocks are sized from free device memory
(``ops.topk.fit_rows``); results do not depend on them.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Optional, Tuple

import msgpack
import numpy as np
import torch

from coltt_tpu_torch.ops.distance import Metric, scan_distances
from coltt_tpu_torch.ops.topk import (
    fit_rows,
    rescore_topk,
    scores_from_negd,
    stable_topk,
)

_CODEBOOK_MAGIC = b"CTTPQCB1"

# sample rows per Lloyd chunk; the training sample is rounded to it
_TRAIN_CHUNK = 4096
_COARSE_BYTES = 2       # uint16 cid packed big-endian into the code prefix
_COARSE_MAX = 1 << 16   # cid must fit the two prefix bytes


def default_subspaces(dim: int, target_dsub: int = 8) -> int:
    """Largest M <= dim/target_dsub that divides dim (dsub >= 2)."""
    m = max(1, dim // target_dsub)
    while m > 1 and dim % m != 0:
        m -= 1
    return m


@dataclass
class PQCodebook:
    """Trained product-quantization codebook (torch tensors on one
    device): ``centroids [M, K, dsub]`` f32, optional OPQ ``rotation
    [D, D]`` (orthonormal), optional residual ``coarse [C, D]``."""

    centroids: torch.Tensor
    rotation: Optional[torch.Tensor] = None
    coarse: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def to(self, device) -> "PQCodebook":
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return PQCodebook(move(self.centroids), move(self.rotation),
                          move(self.coarse))

    @property
    def code_width(self) -> int:
        """Bytes per stored code row (cid prefix + M subspace codes)."""
        return self.m + (_COARSE_BYTES if self.coarse is not None else 0)

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        """Project into the codebook's space (identity when no OPQ)."""
        return x if self.rotation is None else x @ self.rotation

    def derotate(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.rotation is None else x @ self.rotation.t()

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_centroids(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub

    @property
    def centroid_sqnorm(self) -> torch.Tensor:
        """``[M, K]`` squared norms of each centroid (the norm LUT)."""
        return (self.centroids * self.centroids).sum(dim=-1)

    # -- persistence (the reference's CTTPQCB1 bytes) -----------------------
    def save(self, f: io.BufferedIOBase) -> None:
        cents = self.centroids.detach().cpu().numpy().astype(np.float32)
        header = {"m": int(cents.shape[0]), "k": int(cents.shape[1]),
                  "dsub": int(cents.shape[2]),
                  "opq": self.rotation is not None,
                  "coarse": (0 if self.coarse is None
                             else int(self.coarse.shape[0]))}
        hb = msgpack.packb(header, use_bin_type=True)
        f.write(_CODEBOOK_MAGIC)
        f.write(len(hb).to_bytes(8, "big"))
        f.write(hb)
        f.write(cents.tobytes())
        for t in (self.rotation, self.coarse):
            if t is not None:
                f.write(t.detach().cpu().numpy().astype(np.float32).tobytes())

    @classmethod
    def load(cls, f: io.BufferedIOBase, *, device="cuda") -> "PQCodebook":
        magic = f.read(len(_CODEBOOK_MAGIC))
        if magic != _CODEBOOK_MAGIC:
            raise ValueError("not a PQ codebook snapshot")
        hlen = int.from_bytes(f.read(8), "big")
        h = msgpack.unpackb(f.read(hlen), raw=False)
        m, k, dsub = h["m"], h["k"], h["dsub"]
        d = m * dsub

        def read(count, shape):
            raw = np.frombuffer(f.read(count * 4), np.float32).reshape(shape)
            return torch.from_numpy(raw.copy()).to(device)

        cents = read(m * k * dsub, (m, k, dsub))
        rot = read(d * d, (d, d)) if h.get("opq") else None
        c = h.get("coarse", 0)
        coarse = read(c * d, (c, d)) if c else None
        return cls(cents, rot, coarse)


# -- assignment, reconstruction ----------------------------------------------

def _split_cid(codes):
    """Packed residual codes [.., 2+M] -> (cid [..] int64, pq [.., M])."""
    cid = (codes[..., 0].long() << 8) | codes[..., 1].long()
    return cid, codes[..., _COARSE_BYTES:]


def _sub_assign(x_sub, centroids, csq):
    """Nearest centroid per (row, subspace): ``x_sub [M, C, dsub]``,
    ``centroids [M, K, dsub]`` -> ``[M, C]`` int64. Squared L2 argmin
    drops ||x||^2 (constant in k); ties take the first centroid."""
    dots = torch.bmm(x_sub, centroids.transpose(1, 2))     # [M, C, K]
    return torch.argmin(csq[:, None, :] - 2.0 * dots, dim=-1)


def _reconstruct(codes, centroids, dtype, coarse=None):
    """[N, M] (or [N, 2+M] residual) uint8 codes -> [N, D] ``dtype``: the
    concatenated centroids (plus the coarse centroid in residual mode)."""
    cid = None
    if coarse is not None:
        cid, codes = _split_cid(codes)
    n, m = codes.shape
    k = centroids.shape[1]
    table = centroids.to(dtype).reshape(m * k, -1)          # [M*K, dsub]
    offs = torch.arange(m, device=codes.device) * k
    rec = table[codes.long() + offs].reshape(n, -1)
    if coarse is not None:
        rec = rec + coarse[cid].to(dtype)
    return rec


def pq_reconstruct(codes, codebook: PQCodebook, *, derotate: bool = False
                   ) -> torch.Tensor:
    """Decode code rows -> ``[N, D] float32`` in the codebook's (possibly
    rotated) space; ``derotate=True`` maps back to the original
    coordinates."""
    rec = _reconstruct(codes, codebook.centroids, torch.float32,
                       coarse=codebook.coarse)
    return codebook.derotate(rec) if derotate else rec


def _sqnorm_from_codes(codes, csq):
    """LUT sum of centroid squared norms: ``csq [M, K]`` -> ``[N]``."""
    m, k = csq.shape
    offs = torch.arange(m, device=codes.device) * k
    return csq.reshape(-1)[codes.long() + offs].sum(dim=1)


def _recon_sqnorm(codes, centroids, coarse):
    """||reconstruction||^2 of residual codes (the coarse / PQ cross term
    defeats the LUT), blocked over rows."""
    n = codes.shape[0]
    d = centroids.shape[0] * centroids.shape[2]
    out = torch.empty(n, dtype=torch.float32, device=codes.device)
    step = fit_rows(n, d * 12 + codes.shape[1] * 8, codes.device)
    for s in range(0, n, step):
        rec = _reconstruct(codes[s:s + step], centroids, torch.float32, coarse)
        out[s:s + step] = (rec * rec).sum(dim=1)
    return out


def pq_sqnorm(codes, codebook: PQCodebook) -> torch.Tensor:
    """Exact squared reconstruction norms for code rows, blocked over
    rows: LUT-summed in plain mode, reconstructed in residual mode."""
    if codebook.coarse is not None:
        return _recon_sqnorm(codes, codebook.centroids, codebook.coarse)
    n = codes.shape[0]
    csq = codebook.centroid_sqnorm
    out = torch.empty(n, dtype=torch.float32, device=codes.device)
    step = fit_rows(n, codes.shape[1] * 16, codes.device)
    for s in range(0, n, step):
        out[s:s + step] = _sqnorm_from_codes(codes[s:s + step], csq)
    return out


def _coarse_assign(x, coarse):
    """Nearest coarse centroid per row (L2), blocked over rows."""
    csq = (coarse * coarse).sum(dim=1)
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=x.device)
    step = fit_rows(n, coarse.shape[0] * 8, x.device)
    for s in range(0, n, step):
        sims = 2.0 * (x[s:s + step] @ coarse.t()) - csq[None, :]
        out[s:s + step] = torch.argmax(sims, dim=1)
    return out


def _encode_all(x, centroids, csq):
    """[N, D] (already rotated / residual) -> ``[N, M]`` uint8 codes,
    blocked over rows to bound the ``[M, B, K]`` assignment transient."""
    n, _ = x.shape
    m, k, dsub = centroids.shape
    out = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    step = fit_rows(n, m * k * 4 * 3, x.device)
    for s in range(0, n, step):
        xb = x[s:s + step]
        x_sub = xb.reshape(xb.shape[0], m, dsub).transpose(0, 1)  # [M, B, dsub]
        out[s:s + step] = _sub_assign(x_sub, centroids, csq).t().to(torch.uint8)
    return out


def pq_encode(vectors, codebook: PQCodebook) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``[N, D]`` -> ``(codes [N, code_width] uint8, sqnorm [N] f32)``
    on the codebook's device. ``sqnorm`` is the exact squared norm of the
    reconstruction. The input is rotated first (OPQ); in residual mode
    the first two bytes of each row carry the coarse id. Blocked over
    rows, so the rotated and residual copies stay bounded."""
    x = torch.as_tensor(vectors, dtype=torch.float32).to(codebook.device)
    n = x.shape[0]
    width = codebook.code_width
    codes = torch.empty((n, width), dtype=torch.uint8, device=x.device)
    csq = codebook.centroid_sqnorm
    step = fit_rows(n, codebook.dim * 4 * 4, x.device)
    for s in range(0, n, step):
        xb = codebook.rotate(x[s:s + step])
        if codebook.coarse is None:
            codes[s:s + step] = _encode_all(xb, codebook.centroids, csq)
            continue
        cid = _coarse_assign(xb, codebook.coarse)
        codes[s:s + step, 0] = (cid >> 8).to(torch.uint8)
        codes[s:s + step, 1] = (cid & 0xFF).to(torch.uint8)
        codes[s:s + step, _COARSE_BYTES:] = _encode_all(
            xb - codebook.coarse[cid], codebook.centroids, csq)
    return codes, pq_sqnorm(codes, codebook)


# -- training ------------------------------------------------------------------

def _lloyd(x_sub, init, *, n_centroids: int, iters: int, chunk: int):
    """Batched Lloyd's over all subspaces: ``x_sub [M, S, dsub]``, ``init
    [M, K, dsub]``. Empty clusters keep their previous centroid."""
    m, s, dsub = x_sub.shape
    dev = x_sub.device
    offs = (torch.arange(m, device=dev) * n_centroids)[:, None]
    cents = init.clone()
    for _ in range(iters):
        csq = (cents * cents).sum(dim=-1)
        sums = torch.zeros((m * n_centroids, dsub), dtype=torch.float32, device=dev)
        counts = torch.zeros(m * n_centroids, dtype=torch.float32, device=dev)
        for c0 in range(0, s, chunk):
            xb = x_sub[:, c0:c0 + chunk]
            flat = (_sub_assign(xb, cents, csq) + offs).reshape(-1)
            sums.index_add_(0, flat, xb.reshape(-1, dsub))
            counts += torch.bincount(flat, minlength=m * n_centroids)
        new = sums / counts.clamp(min=1.0)[:, None]
        keep = (counts > 0)[:, None]
        cents = torch.where(keep, new, cents.reshape(-1, dsub)).reshape(
            m, n_centroids, dsub)
    return cents


def _coarse_lloyd_step(xs, cents):
    """One whole-vector Lloyd iteration, blocked over rows. Empty clusters
    keep their centroid."""
    c = cents.shape[0]
    assign = _coarse_assign(xs, cents)
    sums = torch.zeros_like(cents).index_add_(0, assign, xs)
    cnt = torch.bincount(assign, minlength=c).to(torch.float32)
    return torch.where(cnt[:, None] > 0, sums / cnt.clamp(min=1.0)[:, None], cents)


def _draw(n: int, count: int, generator: torch.Generator, device) -> torch.Tensor:
    """``count`` distinct indices of ``range(n)``, drawn from ``generator``."""
    perm = torch.randperm(n, generator=generator, device=generator.device)
    return perm[:count].to(device)


def train_pq(
    vectors,
    *,
    m: Optional[int] = None,
    n_centroids: int = 256,
    iters: int = 15,
    sample_size: int = 65_536,
    generator: Optional[torch.Generator] = None,
    opq_iters: int = 0,
    coarse_centroids: int = 0,
    coarse_iters: int = 10,
) -> PQCodebook:
    """Train a PQ codebook on (a sample of) ``vectors [N, D] float32``, on
    the vectors' device (numpy: the CPU).

    ``opq_iters > 0`` adds the OPQ alternation: the rotation starts from
    the sample's PCA eigenvectors (interleaved round-robin across
    subspaces), then each further round re-fits the centroids on the
    rotated sample and solves the orthogonal Procrustes problem for a new
    rotation. ``coarse_centroids > 0`` enables residual mode: a
    whole-vector k-means of that many centroids (<= 65536) on the rotated
    sample, and the subspace codebook re-fit on the residuals. The sample
    and the initial centroids are drawn from ``generator`` (default: a CPU
    generator seeded 0).
    """
    if coarse_centroids < 0 or coarse_centroids > _COARSE_MAX:
        raise ValueError(
            f"coarse_centroids must be 0..{_COARSE_MAX} (uint16 cid prefix)")
    x = torch.as_tensor(vectors, dtype=torch.float32)
    n, dim = x.shape
    if m is None:
        m = default_subspaces(dim)
    if dim % m != 0:
        raise ValueError(f"dim {dim} not divisible by m={m} subspaces")
    if n_centroids > 256:
        raise ValueError("n_centroids > 256 does not fit uint8 codes")
    dsub = dim // m
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dev = x.device

    s = min(n, sample_size)
    s = max(_TRAIN_CHUNK, (s // _TRAIN_CHUNK) * _TRAIN_CHUNK) if s >= _TRAIN_CHUNK else s
    sample = x[_draw(n, s, generator, dev)] if s < n else x
    k = min(n_centroids, s)
    init_rows = _draw(s, k, generator, dev)
    chunk = min(_TRAIN_CHUNK, s)
    if s % chunk:
        chunk = s

    def fit(smp, lloyd_iters):
        x_sub = smp.reshape(s, m, dsub).transpose(0, 1).contiguous()  # [M, S, dsub]
        return _lloyd(x_sub, x_sub[:, init_rows], n_centroids=k,
                      iters=lloyd_iters, chunk=chunk)

    rotation = None
    sample_r = sample
    if opq_iters > 0:
        # PCA init: eigenvectors of the sample covariance (a one-time
        # [D, D] solve on the host); eigenvector i (descending) goes to
        # subspace i % m, slot i // m, so each subspace gets comparable
        # variance
        cov = ((sample.t() @ sample) / max(s - 1, 1)).cpu().numpy()
        _, vecs_ = np.linalg.eigh(cov)
        desc = vecs_[:, ::-1]
        i = np.arange(dim)
        perm = np.empty(dim, np.int64)
        perm[(i % m) * dsub + (i // m)] = i
        rotation = torch.from_numpy(
            np.ascontiguousarray(desc[:, perm]).astype(np.float32)).to(dev)
        sample_r = sample @ rotation

    cents = fit(sample_r, iters)
    for _ in range(max(0, opq_iters - 1)):
        codes = _encode_all(sample_r, cents, (cents * cents).sum(dim=-1))
        # Procrustes: min_R ||sample R - xhat||, R orthonormal, through
        # the SVD of X^T X_hat (accumulated in row blocks)
        mmat = torch.zeros((dim, dim), dtype=torch.float32, device=dev)
        step = fit_rows(s, dim * 8, dev)
        for st in range(0, s, step):
            xh = _reconstruct(codes[st:st + step], cents, torch.float32)
            mmat += sample[st:st + step].t() @ xh
        u, _, vt = np.linalg.svd(mmat.cpu().numpy())
        rotation = torch.from_numpy((u @ vt).astype(np.float32)).to(dev)
        sample_r = sample @ rotation
        cents = fit(sample_r, iters)

    coarse = None
    if coarse_centroids:
        c = min(coarse_centroids, s)
        coarse = sample_r[_draw(s, c, generator, dev)]
        for _ in range(max(1, coarse_iters)):
            coarse = _coarse_lloyd_step(sample_r, coarse)
        cid = _coarse_assign(sample_r, coarse)
        # re-fit the subspace codebook on the residual distribution
        cents = fit(sample_r - coarse[cid], iters)

    if k < n_centroids:  # pad so codes stay uint8-dense
        pad = cents[:, :1].expand(m, n_centroids - k, dsub)
        cents = torch.cat([cents, pad], dim=1)
    return PQCodebook(cents.contiguous(), rotation, coarse)


# -- search ----------------------------------------------------------------------

def pq_scan_neg_topk(
    queries,
    codes,
    centroids,
    sqnorm,
    valid,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=torch.bfloat16,
    block_rows: Optional[int] = None,
    rotation=None,
    coarse=None,
):
    """ADC top-k over PQ codes: ``(negdist [Q, k], ids [Q, k] int32)``.

    Each row block is reconstructed through the codebook gather in
    ``compute_dtype`` and scanned with ``scan_distances``; block-local
    top-k partials merge (any N: the last block is the remainder). Equal
    distances (rows with the same codes) rank the lower row id first, as
    ``lax.top_k`` does.
    ``rotation`` (OPQ) is applied to the queries; codes already live
    rotated. ``block_rows=None`` sizes blocks from free device memory.
    """
    metric = Metric.parse(metric)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=codes.device)
    if rotation is not None:
        queries = queries @ rotation
    n, width = codes.shape
    d = centroids.shape[0] * centroids.shape[2]
    kk = min(k, n)
    if block_rows is None:
        item = torch.empty((), dtype=compute_dtype).element_size()
        per_row = 2 * d * item + 8 * width + 4 * d + 16 * queries.shape[0]
        block_rows = fit_rows(n, per_row, codes.device)
    block = min(block_rows, n)
    vals, ids = [], []
    for s in range(0, n, block):
        e = min(n, s + block)
        rec = _reconstruct(codes[s:e], centroids, compute_dtype, coarse=coarse)
        dist = scan_distances(
            queries, rec, None, sqnorm[s:e],
            None if valid is None else valid[s:e],
            metric=metric, compute_dtype=compute_dtype,
        )
        v, i = stable_topk(-dist, min(kk, e - s))
        vals.append(v)
        ids.append(i + s)
    if len(vals) == 1:
        return vals[0], ids[0].to(torch.int32)
    # block-major partials: equal values keep the lower block first
    negd, sel = stable_topk(torch.cat(vals, 1), kk)
    return negd, torch.gather(torch.cat(ids, 1), 1, sel).to(torch.int32)


def pq_rerank_neg_topk(queries, negd, ids, codes, centroids, *, k,
                       metric: Metric = Metric.COSINE, rotation=None,
                       coarse=None):
    """Re-score a shortlist ``negd / ids [Q, C]`` (from the f8
    reconstruction-cache scan) against the EXACT f32 reconstruction of
    its code rows, gathered from ``codes``. ``queries`` are unrotated;
    pass the codebook rotation."""
    safe = ids.clamp(min=0).reshape(-1).long()
    return pq_rescore_rows(queries, negd, ids, codes[safe], centroids, k=k,
                           metric=metric, rotation=rotation, coarse=coarse)


def pq_rescore_rows(queries, negd, ids, crow, centroids, *, k,
                    metric: Metric = Metric.COSINE, rotation=None,
                    coarse=None):
    """Rescoring tail of :func:`pq_rerank_neg_topk` for callers that
    gather the ``[Q*C, code_width]`` shortlist code rows themselves (the
    host-resident-codes mode). Blocked over queries: the f32
    reconstruction is ``[Q*C, D]``."""
    metric = Metric.parse(metric)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=crow.device)
    if rotation is not None:
        queries = queries @ rotation
    q, c = ids.shape
    d = centroids.shape[0] * centroids.shape[2]
    qb = fit_rows(q, c * (d * 16 + crow.shape[1] * 8), crow.device)
    outs = []
    for s in range(0, q, qb):
        e = min(q, s + qb)
        rec = _reconstruct(crow[s * c:e * c], centroids, torch.float32,
                           coarse=coarse)
        outs.append(rescore_topk(queries[s:e], rec.reshape(e - s, c, d),
                                 negd[s:e], ids[s:e], k=k, metric=metric,
                                 compute_dtype=torch.float32))
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def pq_scan_topk(
    queries, codes, codebook: PQCodebook, sqnorm, valid, *,
    k: int, metric: Metric = Metric.COSINE, compute_dtype=torch.bfloat16,
):
    """Top-k PQ scan with 0-100 scores (scan_topk parity)."""
    metric = Metric.parse(metric)
    negd, idx = pq_scan_neg_topk(
        queries, codes, codebook.centroids, sqnorm, valid,
        k=k, metric=metric, compute_dtype=compute_dtype,
        rotation=codebook.rotation, coarse=codebook.coarse,
    )
    return scores_from_negd(negd, metric), idx

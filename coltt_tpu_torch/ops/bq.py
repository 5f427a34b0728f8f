"""Binary quantization (BQ): 1-bit sign codes, Hamming shortlist, rerank.

Port of ``coltt_tpu/ops/bq.py``. Each vector becomes its sign bits packed
into 32-bit words (``[N, ceil(D/32)]``, 32x smaller than f32). The JAX
package packs into ``uint32``; torch's ``uint32`` lacks most operations,
so the port keeps the same bits in ``int32`` (snapshots are byte-identical)
and masks after every shift, since ``>>`` on ``int32`` is arithmetic.

Search shortlists ``k * oversample`` rows by Hamming distance, in one of
two forms, exactly as the reference blocks them:

- the popcount form (:func:`_hamming`): XOR, then a SWAR popcount on
  the bytes of the result (torch has no popcount operation);
- the +-1 form (:func:`_pm1_dots`): rows and queries unpacked to
  +-1 int8, one s8 x s8 -> s32 product (``torch._int_mm``, the tensor
  cores on a card), ``dot = W*32 - 2*hamming``. Large scans take it.

Hamming distances are integers and tie heavily. ``lax.top_k`` returns the
lower row id first among equal values; ``torch.topk`` promises no order.
The port selects through ``ops.topk.stable_topk``, which keeps that order.
Where the reference takes ``lax.approx_max_k`` (the capped per-block keep
of a multi-block +-1 scan, which a rerank follows) the port skips
settling the tie group at a block's cut: with Hamming ties nearly every
query has one there. The values at every rank stay the reference's; that
group may keep other members, which the rerank scores alike.

BQ is cosine-only: sign bits carry no magnitude.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from coltt_tpu_torch.ops.distance import int8_dot
from coltt_tpu_torch.ops.topk import stable_topk

# transient budget of a scan block on the CPU (the reference's value);
# the tests patch it on both packages to force the blocked forms
_BQ_TRANSIENT_BYTES = 1 << 30
# on a CUDA device: this share of the card's memory, and never more than
# a quarter of what is free (the +-1 form's [Q, B] int32 dots and int64
# keys are about four times the reference's accounting of them)
_CUDA_SHARE = 64
_ALIGN = 8192

# bit j of a word has weight 2^j; bit 31 is the int32 sign
_BIT_WEIGHTS = [1 << j for j in range(31)] + [-(1 << 31)]


def bq_words(dim: int) -> int:
    """32-bit words per packed row."""
    return -(-int(dim) // 32)


def _budget(device: torch.device) -> int:
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        return min(total // _CUDA_SHARE, free // 4)
    return _BQ_TRANSIENT_BYTES


def bq_encode(x) -> torch.Tensor:
    """Pack the sign bits of ``x [..., D] f32`` into ``[..., ceil(D/32)]``
    int32 words (the reference's uint32 bits).

    Bit ``j`` of word ``w`` is ``x[..., 32*w + j] > 0``. Padding dims (when
    D % 32 != 0) are zero bits for every row and every query, so they XOR
    to zero. Rows are packed in blocks, so the int32 bit transient stays
    near the input's own size.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    lead, d = x.shape[:-1], x.shape[-1]
    w = bq_words(d)
    flat = x.reshape(-1, d)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=x.device)
    out = torch.empty((flat.shape[0], w), dtype=torch.int32, device=x.device)
    step = max(1, (64 << 20) // max(1, w * 32 * 4))
    for s in range(0, flat.shape[0], step):
        blk = flat[s:s + step]
        if w * 32 != d:
            blk = torch.nn.functional.pad(blk, (0, w * 32 - d))
        bits = (blk > 0).to(torch.int32).reshape(-1, w, 32)
        # a sum of distinct powers of two, the top one negative: every
        # partial sum stays inside int32, in any order
        out[s:s + step] = (bits * weights).sum(dim=-1, dtype=torch.int32)
    return out.reshape(*lead, w)


def _bits(packed: torch.Tensor, d32: int) -> torch.Tensor:
    """[B, W] int32 words -> [B, W*32] uint8 bits (bit j of word w ->
    column 32w+j). Goes through the words' little-endian bytes: byte i of
    word w holds its bits 8i..8i+7."""
    by = packed.contiguous().view(torch.uint8)                   # [B, 4W]
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((by[:, :, None] >> shifts) & 1).reshape(packed.shape[0], d32)


def _unpack_pm1(packed: torch.Tensor, d32: int) -> torch.Tensor:
    """[B, W] words -> [B, W*32] int8 in {-1, +1}, bq_encode's layout."""
    return _bits(packed, d32).to(torch.int8) * 2 - 1


def _hamming(qp: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
    """qp [Q, W], cp [B, W] int32 -> Hamming [Q, B] int32: XOR, then a
    SWAR popcount on the bytes (uint8, so no shift sign-extends and no
    step overflows), summed over the 4W bytes of a row."""
    x = torch.bitwise_xor(qp[:, None, :], cp[None, :, :]).view(torch.uint8)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return x.sum(dim=-1, dtype=torch.int32)


def _pm1_dots(qi: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
    """qi [Q, W*32] +-1 int8, cp [B, W] words -> [Q, B] int32 dots
    ``W*32 - 2*hamming``, through one s8 x s8 -> s32 product. Padding bits
    decode to -1 on both sides and add the same constant to every dot, so
    the distance they give back is exact."""
    return int8_dot(qi, _unpack_pm1(cp, qi.shape[1]))


# a row that is not valid scores below every valid row (the reference's -inf)
_INVALID = torch.iinfo(torch.int32).min


def _select(score: torch.Tensor, valid, kk: int, start: int = 0, exact: bool = True):
    """Top-kk of a ``[Q, B]`` int32 block of scores (larger is nearer:
    -Hamming, or the +-1 dots) whose rows start at ``start``, equal scores
    by the lower row id: ``(scores [Q, kk], ids [Q, kk])``. ``exact=False``
    is the reference's ``approx_max_k`` (see ``stable_topk``)."""
    if valid is not None:
        score = torch.where(valid[None, :], score, _INVALID)
    v, pos = stable_topk(score, kk, exact=exact)
    return v, pos + start


def _finish(score: torch.Tensor, ids: torch.Tensor, d32: Optional[int] = None):
    """Selected scores -> ``(neg_hamming f32, ids int32)``, -inf where not
    valid. ``d32``: the scores are +-1 dots of that many bits (exact in
    f32: integers below 2^24)."""
    neg = score.to(torch.float32)
    if d32 is not None:
        neg = (neg - d32) * 0.5
    return torch.where(score == _INVALID, -math.inf, neg), ids.to(torch.int32)


def bq_scan_neg_topk(queries_packed, codes_packed, valid, *, k: int,
                     exact: bool = False):
    """Hamming top-k over packed codes.

    ``queries_packed [Q, W]`` / ``codes_packed [N, W]`` int32 words,
    ``valid [N]`` bool or None. Returns ``(neg_hamming [Q, k] f32, ids
    [Q, k] int32)``: negated so larger is better; rows that are not valid
    carry -inf and their own id. The forms follow the reference
    (``coltt_tpu/ops/bq.py:121-234``) on the same budget:

    - a scan whose ``[Q, N, W]`` transient exceeds the budget and whose
      row count divides by 8192 takes the +-1 form in row blocks of the
      reference's size; without ``exact``, each block keeps only
      ``min(kk, block, max(64, ceil(8*kk/blocks)))`` rows (the capped
      keep), which loses a winner only when one block holds more than 8x
      its share of them;
    - any other scan takes the popcount form over all rows at once. (The
      reference's row blocking of this form is unreachable: a scan over
      the budget with N % 8192 == 0 takes the +-1 form.) The port splits
      its queries into chunks whose transient fits the budget, which
      changes no result.
    """
    q, w = queries_packed.shape
    n = codes_packed.shape[0]
    kk = min(k, n)
    budget = _budget(codes_packed.device)

    if q * n * w * 4 > budget and n % _ALIGN == 0:
        d32 = w * 32
        qi = _unpack_pm1(queries_packed, d32)
        bpr = d32 + 4 * q  # transient bytes per row, as the reference counts
        block = max(_ALIGN, (budget // bpr) // _ALIGN * _ALIGN)
        while n % block:
            block -= _ALIGN  # terminates: n % _ALIGN == 0
        blocks = n // block
        if blocks == 1:
            kb = kk
        elif exact:
            kb = min(kk, block)
        else:
            kb = min(kk, block, max(64, -(-8 * kk // blocks)))
        # a capped keep is the reference's approx_max_k
        exact_keep = exact or blocks == 1 or kb == block
        vals, ids = [], []
        for s in range(0, n, block):
            v = None if valid is None else valid[s:s + block]
            score, i = _select(_pm1_dots(qi, codes_packed[s:s + block]), v, kb, s,
                               exact_keep)
            vals.append(score)
            ids.append(i)
        if blocks == 1:
            return _finish(vals[0], ids[0], d32)
        # block-major partials: equal values keep the lower block first
        score, sel = stable_topk(torch.cat(vals, 1), kk)
        return _finish(score, torch.gather(torch.cat(ids, 1), 1, sel), d32)

    qc = max(1, budget // max(1, n * w * 4))
    parts = [_select(-_hamming(queries_packed[s:s + qc], codes_packed), valid, kk)
             for s in range(0, q, qc)]
    return _finish(torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def bq_scan_neg_topk_ref(queries_packed, codes_packed, valid, *, k: int,
                         block: int = 8192):
    """Plain popcount top-k over every row, exact (no capped keep), blocked
    over rows: the yardstick the +-1 form is held to on the card."""
    n = codes_packed.shape[0]
    kk = min(k, n)
    best = None
    for s in range(0, n, block):
        v = None if valid is None else valid[s:s + block]
        score, ids = _select(-_hamming(queries_packed, codes_packed[s:s + block]), v,
                             min(kk, block, n - s), s)
        if best is not None:
            # the kept rows come first and have the lower ids
            score, sel = stable_topk(torch.cat([best[0], score], 1),
                                     min(kk, best[0].shape[1] + score.shape[1]))
            ids = torch.gather(torch.cat([best[1], ids], 1), 1, sel)
        best = (score, ids)
    return _finish(*best)


def bq_decode(packed, dim: int) -> torch.Tensor:
    """Unpack ``[..., W]`` sign words back to ``[..., D]`` f32 in {-1, +1}
    (the only reconstruction 1 bit supports)."""
    lead = packed.shape[:-1]
    w = packed.shape[-1]
    bits = _bits(packed.reshape(-1, w), w * 32)[:, :dim]
    out = torch.where(bits > 0, 1.0, -1.0).to(torch.float32)
    return out.reshape(*lead, dim)


def hamming_to_neg_cos_dist(neg_hamming, dim: int):
    """Negated Hamming -> negated cosine distance via the random-hyperplane
    angle estimate ``cos(theta) ~= cos(pi * H / D)``, so BQ-only results
    sit on the same 0-100 scale as every other mode. -inf passes through."""
    est_cos = torch.cos(math.pi * (-neg_hamming) / float(dim))
    negd = -(1.0 - est_cos)
    return torch.where(torch.isinf(neg_hamming), -math.inf, negd)

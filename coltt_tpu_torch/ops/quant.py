"""Storage quantization codecs (none / f16 / bf16 / f8 / i8) on torch tensors.

Port of ``coltt_tpu/ops/quant.py``. Quantization is a *dtype*:

- f16  -> ``torch.float16``
- bf16 -> ``torch.bfloat16``
- f8   -> ``torch.float8_e4m3fn`` plus a per-row fp32 scale that puts the
  row's absmax at 240, inside the e4m3 range (largest finite 448)
- i8   -> ``torch.int8``: ``round(x / scale)`` clipped to +-127 with
  ``scale = absmax / 127``

Every conversion rounds to nearest even, as ``jnp`` does, so the codes
are bit-identical to the JAX package's on the same f32 input. The enum
numbers are the proto's and must not change.
"""

from __future__ import annotations

import enum

import torch


class Quantization(enum.IntEnum):
    """Matches the proto enum numbering (idl/proto/v4/edge.proto Quantization,
    idl/proto/v3/core.proto Quantization)."""

    NONE = 0
    F16 = 1
    F8 = 2
    BF16 = 3
    PQ = 4
    BQ = 5
    I8 = 6

    @classmethod
    def parse(cls, v) -> "Quantization":
        if isinstance(v, Quantization):
            return v
        if isinstance(v, str):
            key = v.strip().upper()
            aliases = {"": "NONE", "FP16": "F16", "FP8": "F8", "BFLOAT16": "BF16",
                       "INT8": "I8"}
            key = aliases.get(key, key)
            return cls[key]
        return cls(int(v))


_F8_TARGET = 240.0

_STORAGE_DTYPES = {
    Quantization.NONE: torch.float32,
    Quantization.F16: torch.float16,
    Quantization.BF16: torch.bfloat16,
    Quantization.F8: torch.float8_e4m3fn,
    Quantization.I8: torch.int8,
}


def storage_dtype(q: Quantization) -> torch.dtype:
    """dtype used for the stored codes of a quantization scheme."""
    q = Quantization.parse(q)
    if q not in _STORAGE_DTYPES:
        raise ValueError(f"quantization {q.name} has no dense storage dtype")
    return _STORAGE_DTYPES[q]


def bytes_per_component(q: Quantization) -> int:
    """Bytes of one stored component under ``q``."""
    return storage_dtype(q).itemsize


def quantize(x: torch.Tensor, q: Quantization):
    """Quantize ``x: [..., D] float32`` -> ``(codes, scale)``.

    ``codes`` has :func:`storage_dtype`; ``scale`` is ``[..., 1] float32``
    such that ``dequantize(codes, scale) ~= x`` (all-ones for none, f16
    and bf16). Runs on ``x``'s device.
    """
    q = Quantization.parse(q)
    x = torch.as_tensor(x, dtype=torch.float32)
    ones = torch.ones(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    if q == Quantization.NONE:
        return x, ones
    if q in (Quantization.F16, Quantization.BF16):
        return x.to(_STORAGE_DTYPES[q]), ones
    if q in (Quantization.F8, Quantization.I8):
        absmax = x.abs().amax(dim=-1, keepdim=True)
        target = _F8_TARGET if q == Quantization.F8 else 127.0
        scale = torch.where(absmax > 0, absmax / target, torch.ones_like(absmax))
        if q == Quantization.F8:
            return (x / scale).to(torch.float8_e4m3fn), scale
        return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale
    raise ValueError(
        f"quantization {q.name} is not a dense codec (ops.pq / ops.bq encode it)")


def dequantize(codes: torch.Tensor, scale=None) -> torch.Tensor:
    """Inverse of :func:`quantize`; returns float32."""
    out = codes.to(torch.float32)
    if scale is not None:
        out = out * scale
    return out

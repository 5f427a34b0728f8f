"""Port codecs vs the JAX package: codes bit-identical, same fidelity contract.

Both packages quantize the same numpy input; every codec rounds to
nearest even in both frameworks, so codes and scales must agree bit for
bit. The 0-100 cosine score contract of ``tests/test_quant.py`` (<= 1.0
point on dequantized pairs) must hold for the port's codecs too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coltt_tpu.ops.quant import Quantization as JQuant
from coltt_tpu.ops.quant import quantize as j_quantize
from coltt_tpu_torch.ops.distance import Metric, pairwise_distance
from coltt_tpu_torch.ops.quant import (
    Quantization,
    bytes_per_component,
    dequantize,
    quantize,
    storage_dtype,
)
from coltt_tpu_torch.ops.score import denormalize_score, normalize_score

torch.set_num_threads(2)

DENSE = [Quantization.NONE, Quantization.F16, Quantization.BF16,
         Quantization.F8, Quantization.I8]


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def test_enum_numbers_match_the_reference():
    for q in JQuant:
        assert Quantization[q.name] == int(q)
    assert Metric.COSINE == 0 and Metric.EUCLIDEAN == 1 and Metric.MANHATTAN == 2


@pytest.mark.parametrize("q", DENSE, ids=lambda q: q.name)
@pytest.mark.parametrize("dim", [128, 768])
def test_codes_bit_identical_to_jax(q, dim, rng):
    # include exact zeros, a zero row, and values at rounding ties
    x = rng.standard_normal((64, dim)).astype(np.float32)
    x[3] = 0.0
    x[5, :8] = np.array([0.5, 1.5, -2.5, 127.5, 3.0, -0.0, 0.25, 1e-30])
    jc, js = j_quantize(jnp.asarray(x), JQuant(int(q)))
    tc, ts = quantize(torch.from_numpy(x), q)
    assert tc.dtype == storage_dtype(q)
    np.testing.assert_array_equal(_bits(np.asarray(jc)), _torch_bits(tc))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize(
    "q", [Quantization.F16, Quantization.BF16, Quantization.F8, Quantization.I8],
    ids=lambda q: q.name,
)
@pytest.mark.parametrize("dim", [128, 768, 3072])
def test_cosine_score_delta_under_one_point(q, dim, rng):
    xs = torch.from_numpy(rng.standard_normal((256, dim), dtype=np.float32))
    ys = torch.from_numpy(rng.standard_normal((256, dim), dtype=np.float32))
    dx = dequantize(*quantize(xs, q))
    dy = dequantize(*quantize(ys, q))
    s_exact = normalize_score(
        torch.diagonal(pairwise_distance(xs, ys, Metric.COSINE)), Metric.COSINE)
    s_quant = normalize_score(
        torch.diagonal(pairwise_distance(dx, dy, Metric.COSINE)), Metric.COSINE)
    delta = (s_exact - s_quant).abs().max().item()
    assert delta <= 1.0, f"{q.name} dim={dim}: max score delta {delta}"


@pytest.mark.parametrize("q", [Quantization.PQ, Quantization.BQ], ids=lambda q: q.name)
def test_sparse_codecs_not_ported(q):
    """PQ and BQ are no dense codecs (ops.pq / ops.bq encode them): both
    packages refuse them in storage_dtype and quantize with ValueError."""
    from coltt_tpu.ops.quant import storage_dtype as j_storage_dtype

    for dense_only in ((lambda: j_storage_dtype(JQuant(int(q))), lambda: storage_dtype(q)),
                       (lambda: j_quantize(jnp.zeros((2, 8)), JQuant(int(q))),
                        lambda: quantize(torch.zeros(2, 8), q))):
        errors = []
        for fn in dense_only:
            with pytest.raises(Exception) as info:
                fn()
            errors.append(type(info.value))
        assert errors == [ValueError, ValueError]


@pytest.mark.parametrize("metric", list(Metric), ids=lambda m: m.name)
def test_denormalize_score_matches_the_reference(metric, rng):
    """The port's score -> distance map against the reference's, for every
    metric, on scores across the 0-100 scale and past it; the round trip
    through normalize_score returns the distance where no clamp bites."""
    from coltt_tpu.ops.score import denormalize_score as j_denormalize

    scores = np.concatenate([rng.uniform(-20.0, 120.0, 64),
                             [0.0, 50.0, 100.0]]).astype(np.float32)
    got = denormalize_score(torch.from_numpy(scores), metric).numpy()
    want = np.asarray(j_denormalize(jnp.asarray(scores), int(metric)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    dist = torch.from_numpy(rng.uniform(0.0, 2.0, 64).astype(np.float32))
    back = denormalize_score(normalize_score(dist, metric), metric)
    np.testing.assert_allclose(back.numpy(), dist.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("q", list(Quantization), ids=lambda q: q.name)
def test_bytes_per_component_matches_the_reference(q):
    """The stored item size of every quantization, as the reference gives
    it; the sparse codecs raise in both packages."""
    from coltt_tpu.ops.quant import bytes_per_component as j_bytes

    if q in (Quantization.PQ, Quantization.BQ):
        with pytest.raises(ValueError):
            j_bytes(JQuant(int(q)))
        with pytest.raises(ValueError):
            bytes_per_component(q)
        return
    assert bytes_per_component(q) == j_bytes(JQuant(int(q)))
    assert bytes_per_component(q) == storage_dtype(q).itemsize

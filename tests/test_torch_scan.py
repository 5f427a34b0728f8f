"""K1 and the fused scan of the port vs the JAX package (Pallas interpreted).

Inputs are made with numpy and handed to both packages. The JAX kernel
runs interpreted on the CPU, as ``tests/test_scan_pallas.py`` runs it; the
port's wrapper takes its plain version on CPU tensors.

Tolerances, stated once:

- int8 codes, K1 keys: XLA on the CPU contracts the reference kernel's
  epilogue ``dots * rowmul + rowadd`` into one FMA, while the port rounds
  the product and the sum separately (``__fmul_rn`` / ``__fadd_rn`` in the
  CUDA kernel, two tensor ops in the plain version). So a reference key
  may sit one packing step (``nsl`` in int32, the 1-ulp rounding
  difference pushed across the masked low bits) from the port's. The
  port's keys are checked bit for bit against a numpy model of the
  two-rounding epilogue, and against the reference within that one step.
- float codes, K1 keys: the f32 sum over D runs in another order; masked
  values agree within 1e-4 of the bias (D * f32 eps relative to |q||c|,
  with margin).
- fused top-k: ids equal to the reference's; negated distances within
  1e-4 absolute (cosine) or 1e-4 relative to the bias (euclidean), the
  packing perturbation of 2^-18 of the bias and the rounding above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coltt_tpu.ops import scan_pallas as jsp
from coltt_tpu.ops.quant import Quantization as JQuant
from coltt_tpu.ops.quant import dequantize as j_dequantize
from coltt_tpu.ops.quant import quantize as j_quantize
from coltt_tpu_torch.ops import fused_scan as fs
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.topk import scan_topk

torch.set_num_threads(2)

N, D, K = 8192, 128, 5
BIN_ROWS = fs.BIN_ROWS
_NP_INT = {1: np.int8, 2: np.int16, 4: np.int32}
_TORCH_DTYPE = {
    JQuant.NONE: torch.float32,
    JQuant.BF16: torch.bfloat16,
    JQuant.F8: torch.float8_e4m3fn,
    JQuant.I8: torch.int8,
}


def _to_torch(a, dtype=None):
    """numpy / jax array -> torch tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if dtype is None:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(_NP_INT[a.dtype.itemsize]).copy()).view(dtype)


class _Store:
    """One store state in both frameworks."""

    def __init__(self, vecs, quant=JQuant.F8, valid=None):
        n = vecs.shape[0]
        self.j_codes, self.j_scale = j_quantize(jnp.asarray(vecs), quant)
        deq = j_dequantize(self.j_codes, self.j_scale)
        self.j_sqnorm = jnp.sum(deq * deq, axis=1)
        self.valid = np.ones(n, bool) if valid is None else valid
        self.t_codes = _to_torch(self.j_codes, _TORCH_DTYPE[quant])
        self.t_scale = _to_torch(self.j_scale)
        self.t_sqnorm = _to_torch(self.j_sqnorm)
        self.compute = (jnp.float32, torch.float32) if quant == JQuant.NONE \
            else (jnp.bfloat16, torch.bfloat16)

    def jax(self, q, **kw):
        negd, ids = jsp.fused_scan_neg_topk(
            jnp.asarray(q), self.j_codes, self.j_scale, self.j_sqnorm,
            jnp.asarray(self.valid), compute_dtype=self.compute[0], **kw)
        return np.asarray(negd), np.asarray(ids)

    def port(self, q, **kw):
        negd, ids = fs.fused_scan_neg_topk(
            torch.from_numpy(q), self.t_codes, self.t_scale, self.t_sqnorm,
            torch.from_numpy(self.valid), compute_dtype=self.compute[1], **kw)
        return negd.numpy(), ids.numpy()


def _store(rng, n=N, quant=JQuant.F8):
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    return vecs, _Store(vecs, quant)


def _assert_same_topk(jax_out, port_out, bias_tol=None, ties=False):
    """``ties``: the winners' keys are equal, and torch.topk may order
    equal keys other than lax.top_k does: compare the id sets."""
    (jn, ji), (tn, ti) = jax_out, port_out
    if ties:
        np.testing.assert_array_equal(np.sort(ti, axis=1), np.sort(ji, axis=1))
    else:
        np.testing.assert_array_equal(ti, ji)
    finite = np.isfinite(jn)
    np.testing.assert_array_equal(np.isfinite(tn), finite)
    atol = 1e-4 if bias_tol is None else 1e-4 * bias_tol
    np.testing.assert_allclose(tn[finite], jn[finite], rtol=0, atol=atol)


def _bias(store, q, metric):
    inp = fs.scan_inputs(torch.from_numpy(q), store.t_codes, store.t_scale,
                         store.t_sqnorm, None, metric=metric)
    return float(inp["bias"])


# -- K1 keys ---------------------------------------------------------------

def _two_rounding_keys(qi, codes, rowmul, rowadd, chunk):
    """numpy model of K1 on int8 codes, product and sum rounded apart."""
    nsl = chunk // 128
    dots = (qi.astype(np.int64) @ codes.astype(np.int64).T).astype(np.float32)
    val = (dots * rowmul).astype(np.float32) + rowadd
    keys = val.view(np.int32).reshape(qi.shape[0], -1, nsl, 128) & np.int32(-nsl)
    keys |= np.arange(nsl, dtype=np.int32)[None, None, :, None]
    return keys.max(axis=2).reshape(qi.shape[0], -1)


def _check_binmax_scan_ref_against_jax(rng, quant, nq):
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    valid = np.ones(N, bool)
    valid[::7] = False
    st = _Store(vecs, quant, valid)
    q = rng.standard_normal((nq, D)).astype(np.float32)
    inp = fs.scan_inputs(torch.from_numpy(q), st.t_codes, st.t_scale,
                         st.t_sqnorm, torch.from_numpy(valid), metric=Metric.COSINE)
    chunk = fs.chunk_for(N)
    qp = inp["queries"].shape[0]
    j_keys = np.asarray(jsp._binmax_scan(
        jnp.asarray(inp["queries"].numpy()), st.j_codes,
        jnp.asarray(inp["rowmul"].numpy()).reshape(1, N),
        jnp.asarray(inp["rowadd"].numpy()).reshape(1, N),
        compute_dtype=st.compute[0], chunk=chunk, qblock=qp))
    t_keys = fs.binmax_scan(inp["queries"], st.t_codes, inp["rowmul"],
                            inp["rowadd"], chunk=chunk,
                            round_bf16=st.compute[1] == torch.bfloat16).numpy()
    assert t_keys.shape == j_keys.shape == (qp, N // chunk * 128)
    nsl = chunk // 128
    if quant == JQuant.I8:
        model = _two_rounding_keys(inp["queries"].numpy(), np.asarray(st.j_codes),
                                   inp["rowmul"].numpy(), inp["rowadd"].numpy(),
                                   chunk)
        np.testing.assert_array_equal(t_keys, model)
        step = np.abs((t_keys & -nsl).astype(np.int64)
                      - (j_keys & -nsl).astype(np.int64))
        assert step.max() <= nsl
        assert (t_keys == j_keys).mean() > 0.999
    else:
        live = (j_keys > 0)  # valid rows; tombstone keys are negative
        np.testing.assert_array_equal(t_keys > 0, live)
        tv = (t_keys & -nsl).view(np.float32)[live]
        jv = (j_keys & -nsl).view(np.float32)[live]
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4 * float(inp["bias"]))


@pytest.mark.parametrize("quant", [JQuant.I8, JQuant.F8, JQuant.BF16, JQuant.NONE],
                         ids=lambda q: q.name)
def test_binmax_scan_ref_matches_jax_kernel(rng, quant):
    _check_binmax_scan_ref_against_jax(rng, quant, 40)


@pytest.mark.parametrize("nq", [1, 33])
@pytest.mark.parametrize("quant", [JQuant.I8, JQuant.F8], ids=lambda q: q.name)
def test_binmax_scan_ref_matches_jax_kernel_small_q(rng, quant, nq):
    """Q=1 and Q=33 pad to 32 and 64 queries, one int8 query tile each."""
    _check_binmax_scan_ref_against_jax(rng, quant, nq)


# -- the int8 loop's query tile ---------------------------------------------

@pytest.mark.parametrize("qp,qtile", [
    (1, 32), (8, 32), (32, 32), (33, 64), (64, 64), (65, 128), (128, 128),
    (129, 128), (520, 128), (544, 128), (576, 128), (2048, 128)])
def test_int8_tile_plan(qp, qtile):
    """The least of 32, 64 and 128 queries that covers Q, else 128; the
    width plays no part (the kernel streams a tile that does not fit)."""
    assert fs.int8_query_tile(qp) == qtile


_F8, _BF16, _F32, _I8 = (torch.float8_e4m3fn, torch.bfloat16, torch.float32,
                         torch.int8)


@pytest.mark.parametrize("dtype,round_bf16,q,d,plan", [
    # int8 codes: the int8 loop, which decides resident / streamed itself
    (_I8, False, 8, 768, ("int8-wgmma", 32, False)),
    (_I8, True, 2048, 768, ("int8-wgmma", 128, False)),
    # bf16 operands: 128 resident queries fit only up to D=512, then 96
    # (D=768) or 64 (D=1024); past that the tile streams
    (_F8, True, 8, 768, ("bf16-wgmma", 32, False)),
    (_F8, True, 33, 768, ("bf16-wgmma", 64, False)),
    (_F8, True, 2048, 768, ("bf16-wgmma", 96, False)),
    (_BF16, True, 2048, 768, ("bf16-wgmma", 96, False)),
    (_F32, True, 2048, 768, ("bf16-wgmma", 96, False)),
    (_BF16, True, 520, 512, ("bf16-wgmma", 128, False)),
    (_BF16, True, 2048, 1024, ("bf16-wgmma", 64, False)),
    (_F8, True, 520, 2048, ("bf16-wgmma", 128, True)),
    (_BF16, True, 33, 2048, ("bf16-wgmma", 64, True)),
    (_BF16, True, 1, 2048, ("bf16-wgmma", 32, False)),
    (_F32, True, 1, 6144, ("bf16-wgmma", 32, True)),
    # exact f32 operands: the CUDA-core loop, any float code
    (_F32, False, 8, 768, ("f32-simt", 16, False)),
    (_F32, False, 33, 768, ("f32-simt", 64, False)),
    (_F32, False, 2048, 768, ("f32-simt", 128, False)),
    (_F8, False, 520, 6144, ("f32-simt", 128, False)),
    (_BF16, False, 17, 128, ("f32-simt", 32, False)),
])
def test_k1_routing_and_tile_plan(dtype, round_bf16, q, d, plan):
    """Which of K1's loops a call takes, its query tile, and resident or
    streamed queries; every resident plan fits the card's shared memory
    and the widest resident tile is taken."""
    assert fs.k1_plan(dtype, round_bf16, q, d) == plan
    loop, tile, stream = plan
    if loop == "bf16-wgmma":
        assert fs.bf16_smem_bytes(dtype, tile, d, stream) <= fs._SMEM_OPTIN
        if not stream and tile < fs.int8_query_tile(q):
            assert fs.bf16_smem_bytes(dtype, fs.int8_query_tile(q), d,
                                      False) > fs._SMEM_OPTIN


def test_k1_routing_rejects_other_codes():
    with pytest.raises(TypeError):
        fs.k1_loop(torch.float16, True)


def _permute_kblocks(x):
    """The column order kernel_queries gives f8 / f32 codes' queries."""
    r, d = x.shape
    return x.view(r, d // 64, 4, 4, 2, 2).permute(0, 1, 3, 4, 2, 5).reshape(r, d)


@pytest.mark.parametrize("quant", [JQuant.F8, JQuant.BF16, JQuant.NONE],
                         ids=lambda q: q.name)
def test_kernel_queries_round_once_and_give_the_plain_keys(rng, quant):
    """The bf16 loop's query operand, made by the wrapper on the queries'
    device: each value rounded to bf16 once, k-blocks permuted for the
    codes whose A fragments are widened in registers (f8, f32). With the
    code columns permuted alike, the plain version on it gives the keys of
    the plain version on the f32 queries: the same live bins, values
    within 1e-4 of the bias (the f32 sum runs in another order)."""
    n, d = 4096, 256
    st = _Store(rng.standard_normal((n, d)).astype(np.float32), quant)
    q = torch.from_numpy(rng.standard_normal((24, d)).astype(np.float32))
    inp = fs.scan_inputs(q, st.t_codes, st.t_scale, st.t_sqnorm, None,
                         metric=Metric.COSINE)
    kq = fs.kernel_queries(inp["queries"], st.t_codes.dtype, True)
    assert kq.dtype == torch.bfloat16 and kq.shape == inp["queries"].shape
    assert kq.device == inp["queries"].device
    rounded = inp["queries"].to(torch.bfloat16)
    permuted = quant != JQuant.BF16
    want_q = _permute_kblocks(rounded) if permuted else rounded
    assert torch.equal(kq.view(torch.int16), want_q.view(torch.int16))
    codes = (_permute_kblocks(st.t_codes.view(torch.uint8) if quant == JQuant.F8
                              else st.t_codes)
             if permuted else st.t_codes)
    if quant == JQuant.F8:
        codes = codes.contiguous().view(torch.float8_e4m3fn)
    chunk = fs.chunk_for(n)
    got = fs.binmax_scan_ref(kq.float(), codes.contiguous(), inp["rowmul"],
                             inp["rowadd"], chunk=chunk, round_bf16=True)
    want = fs.binmax_scan_ref(inp["queries"], st.t_codes, inp["rowmul"],
                              inp["rowadd"], chunk=chunk, round_bf16=True)
    nsl = chunk // 128
    assert torch.equal(got > 0, want > 0)
    diff = ((got & -nsl).view(torch.float32) - (want & -nsl).view(torch.float32))
    assert diff.abs().max().item() <= 1e-4 * float(inp["bias"])


def test_kernel_queries_of_other_loops_pass_through(rng):
    q = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
    assert fs.kernel_queries(q, torch.float32, False) is q
    qi = torch.zeros((8, 128), dtype=torch.int8)
    assert fs.kernel_queries(qi, torch.int8, False) is qi


@pytest.mark.parametrize("q", [1, 8, 33, 520, 2048])
def test_int8_padding_and_tiles(q):
    """The wrapper pads an int8 batch to a multiple of 32 in blocks of at
    most 512 queries; the padded batch then splits into whole tiles of
    32, 64 or 128 queries except for one ragged last tile."""
    qp, qblock = fs._pick_qblock(q, 32)
    assert qp >= q and qp % 32 == 0 and qp % qblock == 0 and qblock <= 512
    assert qp - q < 32 * (qp // qblock)
    tile = fs.int8_query_tile(qp)
    assert tile >= min(qp, 128) and (qp <= 128 or tile == 128)


def test_supports_int8_width_limit():
    """Int8 codes take the fused scan at every width that is a multiple
    of 128, as float codes do: no shared-memory limit on D."""
    for d in (128, 5120, 5248, 6144, 8192):
        assert fs.supports(8192, d, Metric.COSINE, torch.int8)
        assert fs.supports(8192, d, Metric.COSINE, torch.float8_e4m3fn)
    assert not fs.supports(8192, 6100, Metric.COSINE, torch.int8)


def test_fused_int8_wide_d_matches_plain_scan(rng):
    """D=6144 on int8 codes (the kernel's streamed-query width): the
    fused search finds the plain exact scan's top-1 for a planted row."""
    n, d = 4096, 6144
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((3, d)).astype(np.float32)
    vecs[1234] = q[0]
    j_codes, j_scale = j_quantize(jnp.asarray(vecs), JQuant.I8)
    codes, scale = _to_torch(j_codes, torch.int8), _to_torch(j_scale)
    sqnorm = (torch.from_numpy(vecs) ** 2).sum(1)
    qt = torch.from_numpy(q)
    _, ids = fs.fused_scan_neg_topk(qt, codes, scale, sqnorm, None, k=1)
    _, want = scan_topk(qt, codes, scale, sqnorm, None, k=1)
    assert ids[0, 0].item() == 1234
    np.testing.assert_array_equal(ids.numpy(), want.numpy())


# -- fused top-k: every K1 case of tests/test_scan_pallas.py -----------------

@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN],
                         ids=lambda m: m.name)
def test_fused_matches_jax_on_planted(rng, metric):
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((3, D)).astype(np.float32)
    planted = [17, BIN_ROWS * 5 + 3, BIN_ROWS * 20, BIN_ROWS * 40 + 99,
               BIN_ROWS * 60 + 1]
    for j, slot in enumerate(planted):
        vecs[slot] = q[0] * (1.0 + 0.01 * j)
    st = _Store(vecs)
    port = st.port(q, k=K, metric=metric)
    _assert_same_topk(st.jax(q, k=K, metric=int(metric), final="exact"), port,
                      _bias(st, q, metric) if metric == Metric.EUCLIDEAN else None)
    if metric == Metric.COSINE:
        assert set(port[1][0].tolist()) == set(planted)


@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("quant", [JQuant.F8, JQuant.I8], ids=lambda q: q.name)
def test_fused_matches_jax_on_random(rng, metric, quant):
    """The random-overlap and int8-path cases: same ids and values as the
    reference, and the port's own overlap with its exact plain scan."""
    vecs, st = _store(rng, quant=quant)
    q = rng.standard_normal((4, D)).astype(np.float32)
    port = st.port(q, k=K, metric=metric)
    _assert_same_topk(st.jax(q, k=K, metric=int(metric), final="exact"), port,
                      _bias(st, q, metric) if metric == Metric.EUCLIDEAN else None)
    _, exact_ids = scan_topk(torch.from_numpy(q), st.t_codes, st.t_scale,
                             st.t_sqnorm, torch.from_numpy(st.valid), k=K,
                             metric=metric)
    for r in range(4):
        overlap = set(port[1][r].tolist()) & set(exact_ids[r].tolist())
        assert len(overlap) >= K - 2


def test_fused_query_blocking_matches_jax(rng):
    """Q = 520 > 512 pads to two query blocks."""
    vecs, st = _store(rng, n=2048)
    q = rng.standard_normal((520, D)).astype(np.float32)
    _assert_same_topk(st.jax(q, k=1, final="exact"), st.port(q, k=1))


def test_fused_respects_tombstones_like_jax(rng):
    vecs, st = _store(rng)
    st.valid = np.ones(N, bool)
    st.valid[7] = False
    q = vecs[7:8]
    port = st.port(q, k=3)
    _assert_same_topk(st.jax(q, k=3, final="exact"), port)
    assert 7 not in port[1][0].tolist()


def test_fused_zero_dot_winners_keep_ids():
    """Every winner's raw score is exactly 0.0 and every other row scores
    negative (tests/test_scan_pallas.py): ids must survive the packing."""
    n, d = 2048, 128
    q = np.zeros((1, d), np.float32)
    q[0, 0] = 1.0
    vecs = np.zeros((n, d), np.float32)
    vecs[:, 0] = -0.5
    vecs[:, 1] = 1.0
    planted = [3, BIN_ROWS + 7, 5 * BIN_ROWS + 11, 900, 2047]
    for slot in planted:
        vecs[slot, 0] = 0.0
    st = _Store(vecs, JQuant.NONE)
    port = st.port(q, k=len(planted), final="exact")
    _assert_same_topk(st.jax(q, k=len(planted), final="exact"), port, ties=True)
    assert set(port[1][0].tolist()) == set(planted)
    scores, _ = fs.fused_scan_topk(torch.from_numpy(q), st.t_codes, None,
                                   st.t_sqnorm, None, k=len(planted))
    np.testing.assert_allclose(scores.numpy()[0], 50.0, atol=1e-3)


def test_fused_approx_equals_exact_like_jax(rng):
    """final="approx" is an exact top-k in the port, as ApproxTopK is in
    the reference on the CPU: identical to "exact", and to the JAX
    package's approx, including negative scores and tombstones."""
    n, d = 8192, 128
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs[n // 2:] *= -1.0
    valid = np.ones(n, bool)
    valid[::7] = False
    st = _Store(vecs, JQuant.NONE, valid)
    q = rng.standard_normal((9, d)).astype(np.float32)
    exact = st.port(q, k=32, final="exact")
    approx = st.port(q, k=32, final="approx")
    np.testing.assert_array_equal(exact[0], approx[0])
    np.testing.assert_array_equal(exact[1], approx[1])
    _assert_same_topk(st.jax(q, k=32, final="approx"), approx)


def test_fused_all_invalid(rng):
    vecs, st = _store(rng)
    st.valid = np.zeros(N, bool)
    negd, _ = st.port(vecs[:2], k=3)
    assert np.isneginf(negd).all()
    assert np.isneginf(st.jax(vecs[:2], k=3, final="exact")[0]).all()


def test_supports_and_unported_modes(rng):
    assert fs.supports(8192, 768, Metric.COSINE, torch.float8_e4m3fn)
    assert fs.supports(8192, 768, Metric.COSINE, torch.int8)
    assert not fs.supports(8192, 100, Metric.COSINE, torch.int8)
    assert not fs.supports(1000, 768, Metric.COSINE, torch.int8)
    assert not fs.supports(8192, 768, Metric.MANHATTAN, torch.int8)
    assert not fs.supports(8192, 768, Metric.COSINE, torch.float16)
    assert fs.chunk_for(8192) == 4096 and fs.chunk_for(2048) == 2048
    vecs, st = _store(rng, n=2048)
    assert len(fs.FINALS) == 8
    for final in fs.FINALS:  # every selection of the reference is accepted
        negd, ids = st.port(vecs[:1], k=1, final=final)
        assert ids.shape == (1, 1) and np.isfinite(negd).all(), final
        assert ids[0, 0] == 0, final
    with pytest.raises(ValueError, match="not one of"):
        st.port(vecs[:1], k=1, final="slot3")


def _final_case(rng, case):
    """``(store, queries, k)`` of one case of tests/test_scan_pallas.py's
    slot2 tests: planted rows in distinct bins and slots, a tombstoned
    self-match, and a k wider than the slot2 survivors."""
    n = 2048 if case == "wide-k" else N
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    q = rng.standard_normal((3, D)).astype(np.float32)
    k = K
    if case == "planted":
        for j, slot in enumerate(_PLANTED):
            vecs[slot] = q[0] * (1.0 + 0.01 * j)
    st = _Store(vecs)
    if case == "tombstone":
        st.valid = np.ones(n, bool)
        st.valid[7] = False
        q = vecs[7:8]
        k = 3
    if case == "wide-k":
        k = 64  # nbins = 128 -> width 4, 2 * 4 < 64
    return st, q, k


_PLANTED = [17, BIN_ROWS * 5 + 3, BIN_ROWS * 20, BIN_ROWS * 40 + 99,
            BIN_ROWS * 60 + 1]


@pytest.mark.parametrize("case", ["planted", "tombstone", "wide-k"])
def test_fused_slot2_matches_jax(rng, case):
    """K1 with final="slot2" against the reference's slot2, on the cases
    of tests/test_scan_pallas.py: planted rows in distinct bins and slots,
    a tombstoned self-match, and a k wider than the slot2 survivors
    (exact fallback)."""
    st, q, k = _final_case(rng, case)
    planted = _PLANTED
    port = st.port(q, k=k, final="slot2")
    _assert_same_topk(st.jax(q, k=k, final="slot2"), port)
    if case == "planted":
        assert set(port[1][0].tolist()) == set(planted)
    if case == "tombstone":
        assert 7 not in port[1][0].tolist()
    if case == "wide-k":
        np.testing.assert_array_equal(port[1], st.port(q, k=k, final="exact")[1])


@pytest.mark.parametrize("case", ["planted", "tombstone", "wide-k"])
@pytest.mark.parametrize("final", fs.FINALS)
def test_fused_final_matches_jax(rng, final, case):
    """Every selection of K1's bin survivors against the reference's, on
    the slot2 cases. At these sizes (256 and 64 bins) the reference's
    approx2 takes the exact top-k too, as it does below 16384 bins;
    test_fused_approx2_splits_like_jax holds its split."""
    st, q, k = _final_case(rng, case)
    port = st.port(q, k=k, final=final)
    _assert_same_topk(st.jax(q, k=k, final=final), port)
    if case == "planted":
        assert set(port[1][0].tolist()) == set(_PLANTED)
    if final in ("slot2t", "slot2c", "slot2a"):
        # the same two survivors per slot, and the same exact tail
        np.testing.assert_array_equal(port[1], st.port(q, k=k, final="slot2")[1])
    if final in ("auto", "approx", "approx2"):
        np.testing.assert_array_equal(port[1], st.port(q, k=k, final="exact")[1])


@pytest.mark.parametrize("quant", [JQuant.I8, JQuant.F8], ids=lambda q: q.name)
def test_fused_approx2_splits_like_jax(rng, quant):
    """The reference's approx2 splits the bins in halves from 16384 bins:
    524,288 rows (chunk 4096, so 128 bins a chunk). The port's approx2 is
    its exact top-k (ops/fused_scan.py's docstring); the reference runs K1
    interpreted at this size in about a second, so the whole path is held
    against the reference's split: ids equal to the reference's approx2
    and to the port's exact top-k, with a planted winner in each half and
    a query with its winners in one half only."""
    n = 524_288
    assert n // BIN_ROWS == 16384
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    q = rng.standard_normal((4, D)).astype(np.float32)
    # distinct winners (equal keys may come out in either order)
    bump = 0.1 * rng.standard_normal((5, D)).astype(np.float32)
    vecs[[100, n - 100]] = q[0] + bump[:2]               # one in each half
    vecs[[40, 4096 + 7, 70_000]] = q[1] + bump[2:]       # all in the first
    valid = np.ones(n, bool)
    valid[n // 2 + 5] = False
    vecs[n // 2 + 5] = q[2]                      # a tombstoned self-match
    st = _Store(vecs, quant, valid)
    port = st.port(q, k=16, final="approx2")
    _assert_same_topk(st.jax(q, k=16, final="approx2"), port)
    np.testing.assert_array_equal(port[1], st.port(q, k=16, final="exact")[1])
    assert {100, n - 100} <= set(port[1][0].tolist())
    assert {40, 4096 + 7, 70_000} <= set(port[1][1].tolist())
    assert n // 2 + 5 not in port[1][2].tolist()


def test_wrapper_counts_only_kernel_launches(rng):
    """On CPU tensors the wrapper runs the plain version: no launch."""
    vecs, st = _store(rng, n=2048, quant=JQuant.I8)
    before = fs.binmax_scan.launches
    st.port(vecs[:4], k=3)
    assert fs.binmax_scan.launches == before


@pytest.mark.parametrize("case", ["integer-ties", "gaussian", "all-invalid", "narrow"])
def test_stable_topk_matches_lax_top_k(rng, case):
    """The port's one tie rule against ``lax.top_k``: values and positions
    equal at every rank, equal values by the lower position, on rows wide
    enough for torch.topk (and narrow ones, one stable sort); without
    ``exact``, the values still equal at every rank."""
    import jax

    from coltt_tpu_torch.ops.topk import stable_topk

    n = 1000 if case == "narrow" else 20000
    if case == "gaussian":
        vals = rng.standard_normal((6, n)).astype(np.float32)
    else:
        vals = -rng.integers(0, 40, (6, n)).astype(np.float32)
    vals[:, rng.integers(0, n, 300)] = -np.inf
    if case == "all-invalid":
        vals[2:] = -np.inf
    for k in (1, 37, 640):
        want_v, want_i = map(np.asarray, jax.lax.top_k(jnp.asarray(vals), k))
        got_v, got_i = stable_topk(torch.from_numpy(vals), k)
        np.testing.assert_array_equal(got_v.numpy(), want_v)
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        loose_v, _ = stable_topk(torch.from_numpy(vals), k, exact=False)
        np.testing.assert_array_equal(loose_v.numpy(), want_v)


# -- the CUDA kernel against its plain version (needs a card) ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


# (quantization, round_bf16): each code dtype on its loop, and f32 codes
# under compute_dtype=bf16 on the bf16 loop
_KERNEL_CASES = {
    "I8": (JQuant.I8, False),
    "F8": (JQuant.F8, True),
    "BF16": (JQuant.BF16, True),
    "NONE": (JQuant.NONE, False),
    "NONE-bf16": (JQuant.NONE, True),
    "F8-f32": (JQuant.F8, False),
    "BF16-f32": (JQuant.BF16, False),
}


def _check_kernel_against_plain(rng, dev, quant, round_bf16, q, chunk, d):
    n = 8192 if chunk == 4096 else 6144
    assert fs.chunk_for(n) == chunk
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::5] = False
    st = _Store(vecs, quant, valid)
    qv = torch.from_numpy(rng.standard_normal((q, d)).astype(np.float32))
    inp = fs.scan_inputs(qv.to(dev), st.t_codes.to(dev), st.t_scale.to(dev),
                         st.t_sqnorm.to(dev), torch.from_numpy(valid).to(dev),
                         metric=Metric.COSINE)
    args = (inp["queries"][:q].contiguous(), st.t_codes.to(dev), inp["rowmul"],
            inp["rowadd"])
    kw = dict(chunk=chunk, round_bf16=round_bf16)
    before = fs.binmax_scan.launches
    got = fs.binmax_scan(*args, **kw)
    torch.cuda.synchronize()
    assert fs.binmax_scan.launches == before + 1
    want = fs.binmax_scan_ref(*args, **kw)
    assert got.shape == want.shape == (q, n // chunk * 128)
    if quant == JQuant.I8:
        assert torch.equal(got, want)
    else:
        nsl = kw["chunk"] // 128
        live = want > 0
        assert torch.equal(got > 0, live)
        diff = ((got & -nsl).view(torch.float32)
                - (want & -nsl).view(torch.float32))[live].abs().max()
        assert diff.item() <= 1e-4 * float(inp["bias"])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 768, 2048])
@pytest.mark.parametrize("chunk", [2048, 4096])
@pytest.mark.parametrize("q", [1, 33, 520])
@pytest.mark.parametrize("case", list(_KERNEL_CASES))
def test_kernel_matches_plain_version(rng, cuda_device, case, q, chunk, d):
    """K1 against its plain version at the edges of its loops' tiling: Q
    ragged against the query tiles (the queries go to the kernel
    unpadded), both chunks, and D from one k-block to a width where a
    128-query tile streams through the ring (wider: the streamed-query
    tests). Every code dtype on its loop, f32 codes on the bf16 loop too,
    and f8 / bf16 codes on the exact-f32 loop."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _check_kernel_against_plain(rng, cuda_device, *_KERNEL_CASES[case], q, chunk, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048, 3072, 6144])
@pytest.mark.parametrize("chunk", [2048, 4096])
@pytest.mark.parametrize("q", [1, 33, 520])
@pytest.mark.parametrize("case", ["F8", "BF16"])
def test_bf16_kernel_streamed_queries(rng, cuda_device, case, q, chunk, d):
    """The bf16 loop where its query tile streams through the ring beside
    the codes (bf16_query_tile) and where the 32-query tile just stays
    resident (D=2048): live bins identical, keys within 1e-4 of the
    bias."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _check_kernel_against_plain(rng, cuda_device, *_KERNEL_CASES[case], q, chunk, d)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [2048, 4096])
def test_int8_kernel_all_negative_dots(rng, cuda_device, chunk):
    """Every dot negative (non-negative codes, non-positive queries) and
    raw row factors, so every key is a negative int32: bit-identical."""
    n, d, q = (8192 if chunk == 4096 else 6144), 768, 70
    dev = cuda_device
    codes = torch.from_numpy(rng.integers(0, 128, (n, d)).astype(np.int8)).to(dev)
    qi = torch.from_numpy(-rng.integers(1, 128, (q, d)).astype(np.int8)).to(dev)
    rowmul = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)).to(dev)
    rowadd = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    got = fs.binmax_scan(qi, codes, rowmul, rowadd, chunk=chunk, round_bf16=False)
    torch.cuda.synchronize()
    want = fs.binmax_scan_ref(qi, codes, rowmul, rowadd, chunk=chunk,
                              round_bf16=False)
    assert bool((want < 0).all())
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048, 3072, 6144])
@pytest.mark.parametrize("chunk", [2048, 4096])
@pytest.mark.parametrize("q", [1, 33, 520])
def test_int8_kernel_streamed_queries(rng, cuda_device, q, chunk, d):
    """Widths where the query tile does not stay resident (128 queries
    past D=1152, 64 past 2560, 32 past 5120) and where it just does: the
    queries stream through the ring beside the codes. Raw row factors;
    keys bit-identical."""
    n = 8192 if chunk == 4096 else 6144
    dev = cuda_device
    codes = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8)).to(dev)
    qi = torch.from_numpy(rng.integers(-127, 128, (q, d)).astype(np.int8)).to(dev)
    rowmul = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)).to(dev)
    rowadd = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    before = fs.binmax_scan.launches
    got = fs.binmax_scan(qi, codes, rowmul, rowadd, chunk=chunk, round_bf16=False)
    torch.cuda.synchronize()
    assert fs.binmax_scan.launches == before + 1
    want = fs.binmax_scan_ref(qi, codes, rowmul, rowadd, chunk=chunk,
                              round_bf16=False)
    assert got.shape == (q, n // chunk * 128)
    assert torch.equal(got, want)

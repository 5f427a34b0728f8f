"""K2, the slot2 selection and the unit-norm int8 path of the port vs the
JAX package (Pallas interpreted).

Inputs are made with numpy and handed to both packages. The JAX kernel
runs interpreted on the CPU, as ``tests/test_scan_pallas.py`` runs it; the
port's wrapper takes its plain version on CPU tensors.

Tolerances, stated once:

- K2 keys: bit-identical (integer arithmetic only, shifts of negative
  dots included).
- ``_slot2_select``: ``(sel, pos, drop_bits)`` bit-identical on the same
  keys (integer arithmetic, then an exact top-k). The keys are distinct
  above the member-tag bits, so no two survivors tie: ``torch.topk`` may
  order tied keys differently from ``lax.top_k``.
- ``fused_unit_i8_neg_topk``: ids equal (id sets where the selected keys
  tie, since ``torch.topk`` may order equal keys differently from
  ``lax.top_k``); negated distances within 1e-5 absolute: the same dot
  times a per-query f32 factor, which XLA on the CPU may contract into an
  FMA (one rounding of a value below 2 in magnitude).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coltt_tpu.ops import scan_pallas as jsp
from coltt_tpu_torch.ops import fused_scan as fs

torch.set_num_threads(2)


def _pad_queries(qi):
    q = qi.shape[0]
    qp, qblock = fs._pick_qblock(q, 32)
    out = np.zeros((qp, qi.shape[1]), np.int8)
    out[:q] = qi
    return out, qblock


def _both_keys(qi, codes, chunk):
    qpad, qblock = _pad_queries(qi)
    j = np.asarray(jsp._binmax_scan_i8(jnp.asarray(qpad), jnp.asarray(codes),
                                       chunk=chunk, qblock=qblock))
    t = fs.binmax_scan_i8(torch.from_numpy(qpad), torch.from_numpy(codes),
                          chunk=chunk).numpy()
    return j, t


# -- K2 keys -----------------------------------------------------------------

def _check_binmax_scan_i8_ref_against_jax(rng, chunk, q, d):
    # chunk 2048 needs N % 4096 != 0; D = 2048 keeps N to one or two chunks
    n = {2048: 6144 if d == 128 else 2048, 4096: 8192 if d == 128 else 4096}[chunk]
    assert fs.chunk_for(n) == chunk
    qi = rng.integers(-127, 128, (q, d)).astype(np.int8)
    codes = rng.integers(-127, 128, (n, d)).astype(np.int8)
    if d == 2048:
        # the overflow edge: +-127 rows equal to (or the negation of) a
        # +-127 query reach |dot| = 127^2 * 2048, which << 5 is 1.057e9
        signs = np.where(rng.standard_normal((q, d)) >= 0, 127, -127).astype(np.int8)
        qi = signs
        codes = np.where(rng.standard_normal((n, d)) >= 0, 127, -127).astype(np.int8)
        codes[0] = signs[0]
    # every row of bin 1 of chunk 0 is -q0: the bin's best dot is negative
    nsl = chunk // 128
    sh = nsl.bit_length() - 1
    codes[[s * 128 + 1 for s in range(nsl)]] = -qi[0]
    j, t = _both_keys(qi, codes, chunk)
    assert t.shape == j.shape == (_pad_queries(qi)[0].shape[0], n // chunk * 128)
    np.testing.assert_array_equal(t, j)
    neg = -int(qi[0].astype(np.int64) @ qi[0].astype(np.int64))
    assert t[0, 1] == ((neg << sh) | (nsl - 1)) < 0  # ties -> the last slice
    if d == 2048:
        top = (127 * 127 * 2048) << sh
        assert t[0, 0] == top  # row 0 is slice 0 of bin 0
        assert top + (1 << 30) < 0x7F800000  # the shifted key is no f32 NaN


@pytest.mark.parametrize("d", [128, 2048])
@pytest.mark.parametrize("q", [5, 520])
@pytest.mark.parametrize("chunk", [2048, 4096])
def test_binmax_scan_i8_ref_matches_jax_kernel(rng, chunk, q, d):
    _check_binmax_scan_i8_ref_against_jax(rng, chunk, q, d)


@pytest.mark.parametrize("d", [128, 2048])
@pytest.mark.parametrize("q", [1, 33])
@pytest.mark.parametrize("chunk", [2048, 4096])
def test_binmax_scan_i8_ref_matches_jax_kernel_small_q(rng, chunk, q, d):
    """Q=1 and Q=33: one query tile of 32 or 64 queries in the kernel."""
    _check_binmax_scan_i8_ref_against_jax(rng, chunk, q, d)


def test_binmax_scan_i8_planted_slices(rng):
    """Each planted row wins its bin, and its slice index is the key's
    low bits (slice 0 unmarked)."""
    n, d, chunk = 8192, 128, 4096
    nsl, sh = 32, 5
    qi = rng.integers(-127, 128, (1, d)).astype(np.int8)
    codes = (rng.integers(-127, 128, (n, d)) // 8).astype(np.int8)
    rows = [0, 128 * 7 + 3, 4096 + 128 * 31 + 127]
    for r in rows:
        codes[r] = qi[0]
    j, t = _both_keys(qi, codes, chunk)
    np.testing.assert_array_equal(t, j)
    for r in rows:
        col = (r // chunk) * 128 + r % 128
        assert t[0, col] & (nsl - 1) == (r % chunk) // 128
        assert t[0, col] >> sh == int(qi[0].astype(np.int64) @ qi[0].astype(np.int64))


# -- slot2 selection -----------------------------------------------------------

def _slot2_both(keys, kk, low_bits, float_view):
    j = jsp._slot2_select(jnp.asarray(keys), kk, low_bits, "mask")
    t = fs._slot2_select(torch.from_numpy(keys), kk, low_bits, float_view)
    return [np.asarray(x) for x in j[:2]] + [j[2]], [x.numpy() for x in t[:2]] + [t[2]]


@pytest.mark.parametrize("nb,plan", [(256, (32, 8)), (1280, (10, 128)),
                                     (31360, (35, 896))],
                         ids=["loose", "aligned", "serving"])
def test_slot_plan_matches_jax(nb, plan):
    assert fs._slot_plan(nb) == jsp._slot_plan(nb) == plan
    assert fs._slot_plan(7) is None and jsp._slot_plan(7) is None


@pytest.mark.parametrize("nb", [256, 1280])
@pytest.mark.parametrize("style", ["unit", "k1"])
def test_slot2_select_matches_jax(rng, nb, style):
    """The same keys through both selections: K2-style keys (non-negative,
    ranked as ints) and K1-style keys (positive f32 bit patterns with
    tombstones as negative floats, ranked as their f32 view)."""
    qp, kk, low_bits = 6, 12, 5
    # distinct above bit 10 (the tag takes bits 5..9 at most here)
    high = rng.permutation(1 << 13)[:qp * nb].reshape(qp, nb).astype(np.int32)
    low = rng.integers(0, 1 << 10, (qp, nb)).astype(np.int32)
    if style == "unit":
        keys = (high << 16) | low
        keys[:, ::17] = 0  # dead bins after the +2^30 shift
        float_view = False
    else:
        # f32 bits of values in [1, 2); tombstones as ~-3e38 floats
        keys = np.int32(0x3F800000) | (high << 10) | low
        keys[:, ::5] = (np.float32(-3.0e38) + rng.uniform(
            0, 1e36, (qp, (nb + 4) // 5)).astype(np.float32)).view(np.int32)
        float_view = True
    j, t = _slot2_both(keys, kk, low_bits, float_view)
    assert t[2] == j[2] == low_bits + (fs._slot_plan(nb)[0] - 1).bit_length()
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])


def test_slot2_select_wide_k_falls_back(rng):
    """kk above the 2*width survivors: an exact top-k, drop bits unchanged."""
    keys = rng.permutation(1 << 20)[:768].reshape(3, 256).astype(np.int32)
    j, t = _slot2_both(keys, 24, 4, float_view=False)  # 2 * 8 < 24
    assert t[2] == j[2] == 4
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])


# -- the unit-norm wrapper -------------------------------------------------------

def _unit_state(vecs):
    """Unit-norm rows under one global int8 scale, as the flat index
    quantizes them (numpy, fed to both packages)."""
    un = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-30)
    gscale = np.float32(np.abs(un).max() / 127.0)
    codes = np.clip(np.round(un / gscale), -127, 127).astype(np.int8)
    return codes, gscale


def _unit_both(q, codes, gscale, live, *, k, final):
    jn, ji = jsp.fused_unit_i8_neg_topk(
        jnp.asarray(q), jnp.asarray(codes), jnp.float32(gscale),
        jnp.asarray(live), k=k, final=final)
    tn, ti = fs.fused_unit_i8_neg_topk(
        torch.from_numpy(q), torch.from_numpy(codes),
        torch.tensor(gscale, dtype=torch.float32), torch.from_numpy(live),
        k=k, final=final)
    return (np.asarray(jn), np.asarray(ji)), (tn.numpy(), ti.numpy())


def _assert_same(jax_out, port_out):
    (jn, ji), (tn, ti) = jax_out, port_out
    finite = np.isfinite(jn)
    np.testing.assert_array_equal(np.isfinite(tn), finite)
    np.testing.assert_allclose(tn[finite], jn[finite], rtol=0, atol=1e-5)
    # equal ids, or equal id sets among equal values (tied keys)
    for r in range(ji.shape[0]):
        if not np.array_equal(ti[r], ji[r]):
            np.testing.assert_array_equal(np.sort(tn[r]), np.sort(jn[r]))
            np.testing.assert_array_equal(np.sort(ti[r]), np.sort(ji[r]))


@pytest.mark.parametrize("final", ["exact", "slot2", "auto", "approx"])
def test_fused_unit_i8_matches_jax(rng, final):
    n, d, k = 8192, 128, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((7, d)).astype(np.float32)
    planted = [5, 32 * 9 + 2, 32 * 33, 32 * 71 + 8]
    for j, slot in enumerate(planted):
        vecs[slot] = q[0] * (1.0 + 0.01 * j)
    codes, gscale = _unit_state(vecs)
    valid = np.ones(n, bool)
    valid[4096 + 1024:] = False  # a run of dead bins
    live = jsp.unit_i8_bin_live(valid, jsp.chunk_for(n))
    np.testing.assert_array_equal(
        fs.unit_i8_bin_live(torch.from_numpy(valid), fs.chunk_for(n)).numpy(), live)
    jax_out, port_out = _unit_both(q, codes, gscale, live, k=k, final=final)
    _assert_same(jax_out, port_out)
    assert set(planted) <= set(port_out[1][0].tolist())
    # no id from a dead bin
    dead = ~live[(port_out[1] // 4096) * 128 + port_out[1] % 128]
    assert not dead.any()


def test_fused_unit_i8_auto_is_slot2_at_serving_sizes(rng):
    """Above 8192 bins "auto" is slot2 (nb = 8320: S=13, width 640)."""
    n, d, k = 266_240, 128, 40
    assert fs._slot_plan(n // 32) == (13, 640)
    codes = rng.integers(-30, 31, (n, d)).astype(np.int8)
    q = rng.standard_normal((3, d)).astype(np.float32)
    live = np.ones(n // 32, bool)
    live[-300:] = False
    auto = _unit_both(q, codes, np.float32(0.01), live, k=k, final="auto")
    slot2 = _unit_both(q, codes, np.float32(0.01), live, k=k, final="slot2")
    _assert_same(*auto)
    np.testing.assert_array_equal(auto[1][1], slot2[1][1])
    np.testing.assert_array_equal(auto[1][0], slot2[1][0])


def test_fused_unit_i8_all_dead_bins_are_inf(rng):
    n, d = 4096, 128
    codes, gscale = _unit_state(rng.standard_normal((n, d)).astype(np.float32))
    q = rng.standard_normal((2, d)).astype(np.float32)
    live = np.zeros(n // 32, bool)
    (jn, _), (tn, _) = _unit_both(q, codes, gscale, live, k=5, final="exact")
    assert np.isneginf(jn).all() and np.isneginf(tn).all()


def test_unit_i8_rejects_wide_dims_and_other_finals(rng):
    codes = np.zeros((2048, 2176), np.int8)
    q = torch.from_numpy(rng.standard_normal((1, 2176)).astype(np.float32))
    live = torch.ones(64, dtype=torch.bool)
    with pytest.raises(ValueError, match="dim <= 2048"):
        fs.fused_unit_i8_neg_topk(q, torch.from_numpy(codes), 1.0, live, k=3)
    assert not fs.unit_i8_supports(2048, 2176, "cosine")
    assert fs.unit_i8_supports(2048, 2048, "cosine")
    assert not fs.unit_i8_supports(2048, 128, "euclidean")
    codes = torch.zeros((2048, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="not one of"):
        fs.fused_unit_i8_neg_topk(torch.zeros((1, 128)), codes, 1.0, live, k=3,
                                  final="slot3")


@pytest.mark.parametrize("final", ["slot2t", "slot2c", "slot2a", "approx2"])
def test_fused_unit_i8_other_finals_are_exact(rng, final):
    """The reference sends every final but slot2 and approx to the exact
    top-k on the unit-i8 path (at 8320 bins slot2 has a plan, so slot2
    would differ); the port does the same."""
    n, d, k = 266_240, 128, 40
    codes = rng.integers(-30, 31, (n, d)).astype(np.int8)
    q = rng.standard_normal((3, d)).astype(np.float32)
    live = np.ones(n // 32, bool)
    live[-300:] = False
    got = _unit_both(q, codes, np.float32(0.01), live, k=k, final=final)
    _assert_same(*got)
    exact = _unit_both(q, codes, np.float32(0.01), live, k=k, final="exact")
    np.testing.assert_array_equal(got[1][1], exact[1][1])
    np.testing.assert_array_equal(got[1][0], exact[1][0])


def test_k2_wrapper_counts_only_kernel_launches(rng):
    """On CPU tensors the wrapper runs the plain version: no launch."""
    before = fs.binmax_scan_i8.launches
    fs.binmax_scan_i8(torch.zeros((32, 128), dtype=torch.int8),
                      torch.zeros((2048, 128), dtype=torch.int8), chunk=2048)
    assert fs.binmax_scan_i8.launches == before


# -- the CUDA kernel against its plain version (needs a card) ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 768, 2048])
@pytest.mark.parametrize("chunk", [2048, 4096])
@pytest.mark.parametrize("q", [1, 33, 520])
def test_k2_kernel_matches_plain_version(rng, cuda_device, q, chunk, d):
    """K2 against its plain version at the edges of the int8 loop's tiling
    (Q ragged against the query tile, both chunks, D up to 2048, where
    the 128-query tile streams through the ring), on random codes with a
    planted match and its negation, and on codes whose every dot is
    negative."""
    n = 8192 if chunk == 4096 else 6144
    codes = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    qi = torch.from_numpy(rng.integers(-127, 128, (q, d)).astype(np.int8))
    codes[3] = qi[0]
    codes[n - 5] = -qi[0]
    negative = torch.from_numpy(rng.integers(0, 128, (n, d)).astype(np.int8))
    qneg = torch.from_numpy(-rng.integers(1, 128, (q, d)).astype(np.int8))
    for qs, cs in ((qi, codes), (qneg, negative)):
        args = (qs.to(cuda_device), cs.to(cuda_device))
        before = fs.binmax_scan_i8.launches
        got = fs.binmax_scan_i8(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert fs.binmax_scan_i8.launches == before + 1
        want = fs.binmax_scan_i8_ref(*args, chunk=chunk)
        assert got.shape == (q, n // chunk * 128)
        assert torch.equal(got, want)
    assert bool((want < 0).all())

"""Quantization and MP-MRF selection parity with the reference.

Codes and scales must equal the reference's under ``jax.jit`` bit for
bit: XLA folds the reference's divide by 32767 into a multiply by the
float32 reciprocal, which the port computes too (eager JAX divides, and
differs from both by one ulp on some inputs). The selection rules are fed identical score planes — including ties, where
``jax.lax.top_k`` puts the lower index first and ``jnp.argsort`` is
stable — and must pick identical survivor tables and tiers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import filtering as jflt
from repro.core import quantization as jq
from repro_torch.core import filtering as tflt
from repro_torch.core import quantization as tq
from tests._torch_port import n, t


def _jit_quantize_int16(x, axis):
    codes, scale = jax.jit(
        lambda a: (lambda q: (q.codes, q.scale))(jq.quantize_int16(a, axis))
    )(jnp.asarray(x))
    return jq.QuantizedTensor(codes=codes, scale=scale, axis=axis)


def _jit_quantize_blocks(x, block):
    return jax.jit(lambda a: jq.quantize_int16_blocks(a, block))(
        jnp.asarray(x))


@pytest.mark.parametrize("axis", [-1, (-2, -1), None])
def test_quantize_int16_codes_exact(axis):
    x = np.random.default_rng(0).normal(size=(3, 4, 16, 8)).astype(np.float32)
    ref = _jit_quantize_int16(x, axis)
    out = tq.quantize_int16(t(x), axis=axis)
    np.testing.assert_array_equal(n(out.codes), n(ref.codes))
    np.testing.assert_array_equal(n(out.scale), n(ref.scale))
    for bits in (2, 4, 8):
        np.testing.assert_array_equal(n(out.bit_plane(bits)),
                                      n(ref.bit_plane(bits)))
    np.testing.assert_array_equal(n(out.lsb_remainder(2, 4)),
                                  n(ref.lsb_remainder(2, 4)))
    np.testing.assert_array_equal(n(out.plane_scale(4)),
                                  n(ref.plane_scale(4)))


def test_quantize_blocks_and_view():
    x = np.random.default_rng(1).normal(size=(2, 3, 64, 16)).astype(np.float32)
    x[0, 0, :16] = 0.0                      # an all-zero block: eps floor
    rc, rs = _jit_quantize_blocks(x, 16)
    oc, os_ = tq.quantize_int16_blocks(t(x), 16)
    assert oc.dtype.is_floating_point is False and oc.element_size() == 2
    np.testing.assert_array_equal(n(oc), n(rc))
    np.testing.assert_array_equal(n(os_), n(rs))
    rv = jq.blockwise_quantized_view(rc, rs, 16)
    ov = tq.blockwise_quantized_view(oc, os_, 16)
    np.testing.assert_array_equal(n(ov.codes), n(rv.codes))
    np.testing.assert_array_equal(n(ov.scale), n(rv.scale))


def test_scale_is_the_jitted_reciprocal_multiply():
    """Absmax values for which ``a / 32767`` and ``a · float32(1/32767)``
    round to different float32 scales: the port must give the jitted
    reference's (the multiply), for per-row and per-block scales."""
    absmax = np.array([3.6132073, 3.7459838, 1.7050351, 2.3320215],
                      np.float32)
    divided = absmax / np.float32(tq.INT16_LEVELS)
    multiplied = absmax * np.float32(tq.INV_INT16_LEVELS)
    assert (divided != multiplied).all()      # the case is a real split
    x = np.random.default_rng(6).uniform(-1, 1, size=(4, 16, 8)).astype(
        np.float32)
    x[:, 3, 5] = -absmax                     # each head's absmax
    ref = _jit_quantize_int16(x, (-2, -1))
    out = tq.quantize_int16(t(x), axis=(-2, -1))
    np.testing.assert_array_equal(n(out.scale).ravel(), multiplied)
    np.testing.assert_array_equal(n(out.scale), n(ref.scale))
    np.testing.assert_array_equal(n(out.codes), n(ref.codes))
    rc, rs = _jit_quantize_blocks(x, 16)
    oc, os_ = tq.quantize_int16_blocks(t(x), 16)
    np.testing.assert_array_equal(n(os_).ravel(), multiplied)
    np.testing.assert_array_equal(n(os_), n(rs))
    np.testing.assert_array_equal(n(oc), n(rc))


def _tied_planes(rng, shape, invalid_frac=0.2):
    """Score planes drawn from a handful of values, so ties abound; the
    sums behind the Eq. 3 mean are exact in both frameworks."""
    s0 = rng.integers(-3, 4, size=shape).astype(np.float32) * 0.5
    s1 = rng.integers(-3, 4, size=shape).astype(np.float32) * 0.25
    dead = rng.uniform(size=shape) < invalid_frac
    s0[dead] = jflt.NEG_INF
    s1[dead] = jflt.NEG_INF
    return s0, s1


@pytest.mark.parametrize("alpha", [0.0, 0.3, -0.4])
def test_eq3_threshold(alpha):
    rng = np.random.default_rng(2)
    s, _ = _tied_planes(rng, (5, 7))
    valid = s > jflt.NEG_INF / 2
    ref = jflt.eq3_threshold(jnp.asarray(s), alpha, jnp.asarray(valid))
    out = tflt.eq3_threshold(t(s), alpha, t(valid))
    np.testing.assert_array_equal(n(out), n(ref))


@pytest.mark.parametrize("keep_all", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_prefill_block_select_with_ties(seed, keep_all):
    rng = np.random.default_rng(seed)
    shape = (4, 3, 8)
    s0, s1 = _tied_planes(rng, shape)
    diag = rng.integers(0, 8, size=(4, 3))
    diag_mask = np.arange(8)[None, None, :] == diag[..., None]
    kw = dict(round_bits=(2, 4), alphas=(0.0, 0.0), granularity="block",
              query_block=8, key_block=8, block_budget=3, keep_all=keep_all)
    ref = jflt.prefill_block_select_from_planes(
        [jnp.asarray(s0), jnp.asarray(s1)], jnp.asarray(s0 > -5e29),
        jflt.MPMRFConfig(**kw), diag_mask=jnp.asarray(diag_mask),
        with_stats=True)
    out = tflt.prefill_block_select_from_planes(
        [t(s0), t(s1)], t(s0 > -5e29), tflt.MPMRFConfig(**kw),
        diag_mask=t(diag_mask), with_stats=True)
    for field in ("keep_mask", "block_indices", "block_valid", "sel_tier"):
        np.testing.assert_array_equal(n(getattr(out, field)),
                                      n(getattr(ref, field)), err_msg=field)
    np.testing.assert_array_equal(n(tflt.selection_stats(out)),
                                  n(jflt.selection_stats(ref)))


@pytest.mark.parametrize("with_live", [False, True])
def test_decode_tier_select_with_ties(with_live):
    rng = np.random.default_rng(5)
    s0, s1 = _tied_planes(rng, (6, 10))
    valid = s0 > jflt.NEG_INF / 2
    keep = valid & (s1 >= 0.0)
    newest = rng.integers(0, 10, size=(6,))
    live = rng.integers(1, 6, size=(6,)).astype(np.int32) if with_live else None
    ref = jflt.decode_block_tier_select(
        jnp.asarray(s1), jnp.asarray(keep), jnp.asarray(valid),
        jnp.asarray(newest), 4,
        live_budget=None if live is None else jnp.asarray(live),
        with_tiers=True)
    out = tflt.decode_block_tier_select(
        t(s1), t(keep), t(valid), t(newest), 4,
        live_budget=None if live is None else t(live), with_tiers=True)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(n(o), n(r))


def test_top_k_stable_matches_lax_top_k():
    import jax

    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -1e30, -1e30, 2.0]], np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 6)
    ov, oi = tflt.top_k_stable(t(x), 6)
    np.testing.assert_array_equal(n(oi), n(ri))
    np.testing.assert_array_equal(n(ov), n(rv))

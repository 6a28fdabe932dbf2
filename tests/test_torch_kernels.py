"""The port's kernels (their plain PyTorch versions, on the CPU) against
the reference's Pallas kernels in interpret mode, on the same numpy
inputs: the filter scores (B1, B3) bit for bit, the survivor gathers
(B2, B4) at fp32 atol = rtol = 1e-5 (the two sum the same products in
different orders). Last, the bf16 tolerance the card holds B2/B4 to is
shown to pass a reordering of the same sums and to fail wrong kernels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mpmrf_decode as jdec
from repro.kernels import mpmrf_prefill as jpre
from repro_torch.kernels import gather_within_tolerance
from repro_torch.kernels import mpmrf_decode as tdec
from repro_torch.kernels import mpmrf_prefill as tpre
from tests._torch_port import n, t

BH, G, D, BK, MB, PAGES = 4, 4, 16, 16, 5, 12
N_Q, BQ = 32, 16


def _filter_operands(rng, rows, hi=4):
    half = 1 << (hi - 1)                 # the q plane of hi bits
    q_plane = rng.integers(-half, half, size=(BH, rows, D)).astype(np.int32)
    q_scale = rng.uniform(1e-5, 1e-3, size=(BH, rows, 1)).astype(np.float32)
    codes = rng.integers(-32767, 32768, size=(PAGES, BK, D)).astype(np.int16)
    scale = rng.uniform(1e-5, 1e-3, size=(PAGES, 1)).astype(np.float32)
    table = np.stack([rng.permutation(PAGES)[:MB] for _ in range(BH)])
    return q_plane, q_scale, codes, scale, table.astype(np.int32)


def _gather_operands(rng, rows, budget_shape):
    q = rng.normal(size=(BH, rows, D)).astype(np.float32)
    k = rng.normal(size=(PAGES, BK, D)).astype(np.float32)
    v = rng.normal(size=(PAGES, BK, D)).astype(np.float32)
    table = np.stack([rng.permutation(PAGES)[:MB] for _ in range(BH)])
    idx = rng.integers(0, MB, size=budget_shape).astype(np.int32)
    val = (rng.uniform(size=budget_shape) < 0.75).astype(np.int32)
    return q, k, v, table.astype(np.int32), idx, val


@pytest.mark.parametrize("seed,round_bits", [
    pytest.param(0, (2, 4), id="0"), pytest.param(1, (2, 4), id="1"),
    pytest.param(0, (1, 8), id="0-lo1-hi8"),
    # lo = 0: the msb plane is the code's sign, the remainder reaches 255
    pytest.param(1, (0, 8), id="1-lo0-hi8"),
])
def test_b1_paged_filter_scores_bit_exact(seed, round_bits):
    rng = np.random.default_rng(seed)
    qp, qs, codes, scale, table = _filter_operands(rng, G, round_bits[1])
    # lengths: one slot sees a single block, one sees none of the last
    cl = np.array([1, 17, MB * BK, 50], np.int32)
    ref = jdec.mpmrf_paged_filter_scores(
        jnp.asarray(qp), jnp.asarray(qs), jnp.asarray(codes),
        jnp.asarray(scale), jnp.asarray(table), jnp.asarray(cl),
        round_bits=round_bits, key_block=BK, interpret=True,
    )
    out = tdec.paged_filter_scores(
        t(qp), t(qs), t(codes), t(scale), t(table), t(cl),
        round_bits=round_bits, key_block=BK,
    )
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(n(r), n(o))
    assert (n(out[0])[0, 1:] == tdec.NEG_INF).all()


def test_b2_paged_decode_gather_matches_pallas():
    rng = np.random.default_rng(2)
    q, k, v, table, idx, val = _gather_operands(rng, G, (BH, 3))
    val[0] = 0                           # a row with no valid slot → zeros
    cl = np.array([40, 80, 5, 33], np.int32)
    ref = jdec.paged_decode_gather_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx),
        jnp.asarray(val), jnp.asarray(table), jnp.asarray(cl),
        key_block=BK, interpret=True,
    )
    out = tdec.paged_decode_gather_attention(
        t(q), t(k), t(v), t(idx), t(val), t(table), t(cl), key_block=BK,
    )
    np.testing.assert_allclose(n(out), n(ref), atol=1e-5, rtol=1e-5)
    assert not n(out)[0].any()


def _qpos(rng):
    n_k = MB * BK
    pos = np.zeros((BH, N_Q), np.int32)
    for b in range(BH):
        pos[b] = rng.integers(0, n_k - N_Q) + np.arange(N_Q)
    pos[1, -5:] = n_k                     # ragged tail: sentinel rows
    pos[3, :] = n_k                       # an idle slot: all sentinels
    return pos


@pytest.mark.parametrize("seed", [3, 4])
def test_b3_paged_prefill_filter_scores_bit_exact(seed):
    rng = np.random.default_rng(seed)
    qp, qs, codes, scale, table = _filter_operands(rng, N_Q)
    qpos = _qpos(rng)
    ref = jpre.mpmrf_paged_prefill_filter_scores(
        jnp.asarray(qp), jnp.asarray(qs), jnp.asarray(qpos),
        jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(table),
        round_bits=(2, 4), query_block=BQ, key_block=BK, interpret=True,
    )
    out = tpre.paged_prefill_filter_scores(
        t(qp), t(qs), t(qpos), t(codes), t(scale), t(table),
        round_bits=(2, 4), query_block=BQ, key_block=BK,
    )
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(n(r), n(o))
    assert (n(out[1])[3] == tpre.NEG_INF).all()


def test_b4_paged_prefill_gather_matches_pallas():
    rng = np.random.default_rng(5)
    q, k, v, table, idx, val = _gather_operands(rng, N_Q, (BH, N_Q // BQ, 3))
    qpos = _qpos(rng)
    ref = jpre.paged_prefill_gather_attention(
        jnp.asarray(q), jnp.asarray(qpos), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(table),
        query_block=BQ, key_block=BK, interpret=True,
    )
    out = tpre.paged_prefill_gather_attention(
        t(q), t(qpos), t(k), t(v), t(idx), t(val), t(table),
        query_block=BQ, key_block=BK,
    )
    np.testing.assert_allclose(n(out), n(ref), atol=1e-5, rtol=1e-5)
    assert not n(out)[3].any()           # sentinel rows attend nothing


def _b2_bf16(rng, variant):
    q, k, v, table, idx, val = _gather_operands(rng, G, (BH, 3))
    cl = np.array([40, 50, 5, 33], np.int32)
    idx[:, 0], val[:, 0] = cl // BK, 1   # the page holding key ``cl``
    q, k, v = (t(x, torch.bfloat16) for x in (q, k, v))
    idx, val, table, cl = t(idx), t(val), t(table), t(cl)
    ref = tdec.paged_decode_gather_attention(q, k, v, idx, val, table, cl,
                                             key_block=BK)
    kw = dict(key_block=BK)
    if variant == "scale+2%":
        kw["scale"] = 1.02 / D ** 0.5
    elif variant == "mask+1":              # the length mask lets key cl in
        cl = cl + 1
    return tdec.paged_decode_gather_attention(q, k, v, idx, val, table, cl,
                                              **kw), ref


def _b4_bf16(rng, variant):
    q, k, v, table, idx, val = _gather_operands(rng, N_Q, (BH, N_Q // BQ, 3))
    qpos = _qpos(rng)
    # each query block's first slot: the page of its last row's next key
    last = qpos.reshape(BH, N_Q // BQ, BQ)[..., -1]
    idx[..., 0], val[..., 0] = np.minimum((last + 1) // BK, MB - 1), 1
    q, k, v = (t(x, torch.bfloat16) for x in (q, k, v))
    idx, val, table, qpos = t(idx), t(val), t(table), t(qpos)
    kw = dict(query_block=BQ, key_block=BK)
    ref = tpre.paged_prefill_gather_attention(q, qpos, k, v, idx, val, table,
                                              **kw)
    if variant == "scale+2%":
        kw["scale"] = 1.02 / D ** 0.5
    elif variant == "mask+1":              # the causal mask lets kpos+1 in
        qpos = qpos + 1
    return tpre.paged_prefill_gather_attention(q, qpos, k, v, idx, val,
                                               table, **kw), ref


@pytest.mark.parametrize("kernel", ["B2", "B4"])
@pytest.mark.parametrize("variant, within", [
    ("one ulp", True), ("scale+2%", False), ("mask+1", False)])
def test_gather_tolerance_separates_rounding_from_faults(kernel, variant,
                                                         within):
    """Every element one bf16 ulp further from 0 (the most that rounding
    the f32 result differently can do) passes; a softmax scale off by
    2 % or a mask that admits one more key fails."""
    make = _b2_bf16 if kernel == "B2" else _b4_bf16
    out, ref = make(np.random.default_rng(6), variant)
    if variant == "one ulp":
        out = (ref.view(torch.int16) + 1).view(torch.bfloat16)
    assert gather_within_tolerance(out, ref) is within

"""Head dims past the kernels' four instantiations, on the CPU.

Every kernel (B1–B11) takes each head dim d ≤ 128 with d % 16 == 0: it
reads d columns, zero-fills columns d … D − 1 of its tiles in shared
memory and runs the instantiation D = ``kernel_head_dim(d)`` (16, 32, 64
or 128). Here: the predicate and the instantiation of each d, the
wrappers' checks taking and refusing the same set with the head dim
named, and the tile engine's shared memory laid out for the
instantiation; then each kernel's plain version against the Pallas
kernel in interpret mode at d 80, 96 (phi3-mini's) and 112 (zamba2's
attention), on the same numpy inputs. Filter scores (B1, B3, B5, B7,
B9) exactly; attention outputs (B2, B4, B6, B8, B10, B11) at fp32 atol
= rtol = 1e-5, the same products summed in another order. The kernels
themselves are held to these plain versions at the same head dims on
the card (``tests/test_torch_cuda.py``)."""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mpmrf_decode as jdec
from repro.kernels import mpmrf_filter as jfilt
from repro.kernels import mpmrf_prefill as jpre
from repro_torch.kernels import block_sparse_attention as tbsa
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mpmrf_decode as tdec
from repro_torch.kernels import mpmrf_filter as tfilt
from repro_torch.kernels import mpmrf_prefill as tpre
from tests._torch_port import n, t

# the modules (``repro.kernels`` exports their functions under the same
# names)
jbsa = importlib.import_module("repro.kernels.block_sparse_attention")
jfa = importlib.import_module("repro.kernels.flash_attention")

#: the head dims the CUDA kernels run padded to D = 128
HEAD_DIMS = (80, 96, 112)
TOL = dict(atol=1e-5, rtol=1e-5)
BH, G, BK, MB, PAGES, N_Q, BQ = 4, 3, 16, 4, 10, 32, 16
N_K = MB * BK
N, BLK = 64, 16                 # B9–B11: [BH, N, d], blocks of 16


@pytest.mark.parametrize("d, inst", [
    (16, 16), (32, 32), (48, 64), (64, 64), (80, 128), (96, 128),
    (112, 128), (128, 128)])
def test_every_multiple_of_16_up_to_128_runs_the_next_instantiation(d,
                                                                     inst):
    """16·k ≤ 128 is taken by every wrapper's check, and runs the least
    instantiation ≥ d; the tile engine's shared memory is that
    instantiation's (a block of 64 rows on the wgmma path from D 64)."""
    assert tdec.kernel_head_dim(d) == inst
    tdec.check_head_dim(d)
    tdec.check_decode_filter_launch(5, d, 64, (2, 4))
    tdec.check_decode_gather_launch(5, d, 64, torch.bfloat16)
    tfilt.check_filter_launch(d, 128, 64, (2, 4))
    tfa.check_tile_engine(d, torch.bfloat16, 128, 64, 33)
    for bq, rows in ((128, 64 if inst >= 64 else 128), (48, 48)):
        assert (tfa.engine_smem_bytes(d, bq)
                == 2 * inst * (rows + 2 * tfa.STAGES * tfa.KEY_TILE))
        assert (tfa.engine_smem_bytes(d, bq, 33)
                == tfa.engine_smem_bytes(inst, bq, 33))


@pytest.mark.parametrize("d", [8, 24, 136, 192])
def test_head_dims_no_kernel_takes_are_refused_by_name(d):
    """d 8 (the reference's test models), 24 (a multiple of 8 only: its
    int8 plane rows break 16-byte copies), and 136 and 192 (past 128)."""
    assert tdec.kernel_head_dim(d) == 0
    message = re.escape(f"head_dim {d} must be a multiple of 16, <= 128")
    for check in (
            lambda: tdec.check_head_dim(d),
            lambda: tdec.check_decode_filter_launch(5, d, 64, (2, 4)),
            lambda: tdec.check_decode_gather_launch(5, d, 64,
                                                    torch.bfloat16),
            lambda: tfilt.check_filter_launch(d, 128, 64, (2, 4)),
            lambda: tfa.check_tile_engine(d, torch.bfloat16, 128, 64),
            lambda: tfa.engine_smem_bytes(d, 128)):
        with pytest.raises(ValueError, match=message):
            check()


# ---------------------------------------------------------------------------
# each kernel's plain version against the Pallas kernel at d 80 / 96 / 112
# ---------------------------------------------------------------------------


def _planes(rng, rows, d, hi=4):
    half = 1 << (hi - 1)
    qp = rng.integers(-half, half, size=(BH, rows, d)).astype(np.int32)
    qs = rng.uniform(1e-5, 1e-3, size=(BH, rows, 1)).astype(np.float32)
    return qp, qs


def _codes(rng, shape):
    return rng.integers(-32767, 32768, size=shape).astype(np.int16)


def _table(rng):
    return np.stack([rng.permutation(PAGES)[:MB]
                     for _ in range(BH)]).astype(np.int32)


def _qpos(rng):
    pos = np.stack([rng.integers(0, N_K - N_Q) + np.arange(N_Q)
                    for _ in range(BH)]).astype(np.int32)
    pos[1, -5:] = N_K                     # a ragged tail of sentinel rows
    return pos


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _exact(ref, out):
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(n(r), n(o))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b1_paged_filter_scores_bit_exact(d):
    rng = np.random.default_rng(d)
    qp, qs = _planes(rng, G, d)
    codes = _codes(rng, (PAGES, BK, d))
    scale = rng.uniform(1e-5, 1e-3, size=(PAGES, 1)).astype(np.float32)
    table, cl = _table(rng), np.array([1, 17, N_K, 50], np.int32)
    args = (qp, qs, codes, scale, table, cl)
    ref = jdec.mpmrf_paged_filter_scores(*_j(*args), key_block=BK,
                                         interpret=True)
    _exact(ref, tdec.paged_filter_scores(*map(t, args), key_block=BK))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b2_paged_decode_gather_matches_pallas(d):
    rng = np.random.default_rng(d + 1)
    q, k, v = (_normal(rng, *s) for s in ((BH, G, d), (PAGES, BK, d),
                                          (PAGES, BK, d)))
    idx = rng.integers(0, MB, size=(BH, 3)).astype(np.int32)
    val = (rng.uniform(size=(BH, 3)) < 0.75).astype(np.int32)
    args = (q, k, v, idx, val, _table(rng),
            np.array([40, 60, 5, 33], np.int32))
    ref = jdec.paged_decode_gather_attention(*_j(*args), key_block=BK,
                                             interpret=True)
    out = tdec.paged_decode_gather_attention(*map(t, args), key_block=BK)
    np.testing.assert_allclose(n(out), n(ref), **TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b3_paged_prefill_filter_scores_bit_exact(d):
    rng = np.random.default_rng(d + 2)
    qp, qs = _planes(rng, N_Q, d)
    codes = _codes(rng, (PAGES, BK, d))
    scale = rng.uniform(1e-5, 1e-3, size=(PAGES, 1)).astype(np.float32)
    args = (qp, qs, _qpos(rng), codes, scale, _table(rng))
    kw = dict(query_block=BQ, key_block=BK)
    ref = jpre.mpmrf_paged_prefill_filter_scores(
        *_j(*args), round_bits=(2, 4), interpret=True, **kw)
    _exact(ref, tpre.paged_prefill_filter_scores(*map(t, args), **kw))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b4_paged_prefill_gather_matches_pallas(d):
    rng = np.random.default_rng(d + 3)
    q, k, v = (_normal(rng, *s) for s in ((BH, N_Q, d), (PAGES, BK, d),
                                          (PAGES, BK, d)))
    shape = (BH, N_Q // BQ, 3)
    idx = rng.integers(0, MB, size=shape).astype(np.int32)
    val = (rng.uniform(size=shape) < 0.75).astype(np.int32)
    args = (q, _qpos(rng), k, v, idx, val, _table(rng))
    kw = dict(query_block=BQ, key_block=BK)
    ref = jpre.paged_prefill_gather_attention(*_j(*args), interpret=True,
                                              **kw)
    out = tpre.paged_prefill_gather_attention(*map(t, args), **kw)
    np.testing.assert_allclose(n(out), n(ref), **TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b5_decode_filter_scores_bit_exact(d):
    rng = np.random.default_rng(d + 4)
    qp, qs = _planes(rng, G, d)
    codes = _codes(rng, (BH, N_K, d))
    scale = rng.uniform(1e-5, 1e-3, size=(BH, MB)).astype(np.float32)
    args = (qp, qs, codes, scale, np.array([1, N_K, N_K + 1, 37], np.int32))
    ref = jdec.mpmrf_decode_filter_scores(*_j(*args), key_block=BK,
                                          interpret=True)
    _exact(ref, tdec.mpmrf_decode_filter_scores(*map(t, args),
                                                key_block=BK))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b6_decode_gather_matches_pallas(d):
    rng = np.random.default_rng(d + 5)
    q, k, v = (_normal(rng, *s) for s in ((BH, G, d), (BH, N_K, d),
                                          (BH, N_K, d)))
    idx = rng.integers(0, MB, size=(BH, 3)).astype(np.int32)
    val = (rng.uniform(size=(BH, 3)) < 0.75).astype(np.int32)
    args = (q, k, v, idx, val, np.array([40, 60, N_K + 1, 33], np.int32))
    ref = jdec.decode_gather_attention(*_j(*args), key_block=BK,
                                       interpret=True)
    out = tdec.decode_gather_attention(*map(t, args), key_block=BK)
    np.testing.assert_allclose(n(out), n(ref), **TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b7_prefill_filter_scores_bit_exact(d):
    rng = np.random.default_rng(d + 6)
    qp, qs = _planes(rng, N_Q, d)
    codes = _codes(rng, (BH, N_K, d))
    row_scale = np.repeat(
        rng.uniform(1e-5, 1e-3, size=(BH, MB)).astype(np.float32), BK,
        axis=-1)
    args = (qp, qs, _qpos(rng), codes, row_scale)
    kw = dict(query_block=BQ, key_block=BK)
    ref = jpre.mpmrf_prefill_filter_scores(*_j(*args), interpret=True, **kw)
    _exact(ref, tpre.mpmrf_prefill_filter_scores(*map(t, args), **kw))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b8_prefill_gather_matches_pallas(d):
    rng = np.random.default_rng(d + 7)
    q, k, v = (_normal(rng, *s) for s in ((BH, N_Q, d), (BH, N_K, d),
                                          (BH, N_K, d)))
    shape = (BH, N_Q // BQ, 3)
    idx = rng.integers(0, MB, size=shape).astype(np.int32)
    val = (rng.uniform(size=shape) < 0.75).astype(np.int32)
    args = (q, _qpos(rng), k, v, idx, val)
    kw = dict(query_block=BQ, key_block=BK)
    ref = jpre.prefill_gather_attention(*_j(*args), interpret=True, **kw)
    out = tpre.prefill_gather_attention(*map(t, args), **kw)
    np.testing.assert_allclose(n(out), n(ref), **TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b9_filter_scores_bit_exact(d):
    rng = np.random.default_rng(d + 8)
    qp = rng.integers(-8, 8, size=(BH, N, d)).astype(np.int8)
    msb = rng.integers(-2, 2, size=(BH, N, d)).astype(np.int8)
    rem = rng.integers(0, 4, size=(BH, N, d)).astype(np.int8)
    qs = rng.uniform(1e-5, 1e-3, size=(BH, N, 1)).astype(np.float32)
    kw = dict(shift=2, query_block=BLK, key_block=BLK, causal=True,
              q_offset=16)
    ref = jfilt.mpmrf_filter_scores(*_j(qp, msb, rem, qs), interpret=True,
                                    **kw)
    _exact(ref, tfilt.mpmrf_filter_scores(t(qp), t(msb), t(rem), t(qs),
                                          **kw))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b10_block_sparse_attention_matches_pallas(d):
    rng = np.random.default_rng(d + 9)
    q, k, v = (_normal(rng, BH, N, d) for _ in range(3))
    shape = (BH, N // BLK, 2)
    idx = rng.integers(0, N // BLK, size=shape).astype(np.int32)
    val = (rng.uniform(size=shape) < 0.8).astype(np.int32)
    kw = dict(query_block=BLK, key_block=BLK, causal=True, q_offset=0)
    ref = jbsa.block_sparse_attention(*_j(q, k, v, idx, val),
                                      interpret=True, **kw)
    out = tbsa.block_sparse_attention(*map(t, (q, k, v, idx, val)), **kw)
    np.testing.assert_allclose(n(out), n(ref), **TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b11_flash_attention_matches_pallas(d):
    rng = np.random.default_rng(d + 10)
    q, k, v = (_normal(rng, BH, N, d) for _ in range(3))
    kw = dict(causal=True, q_offset=0, block_q=BLK, block_k=BLK)
    ref = jfa.flash_attention(*_j(q, k, v), interpret=True, **kw)
    out = tfa.flash_attention(t(q), t(k), t(v), **kw)
    np.testing.assert_allclose(n(out), n(ref), **TOL)

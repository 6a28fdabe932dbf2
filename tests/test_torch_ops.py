"""The port's fused paged ops against the reference's
``fused_paged_decode_attention`` / ``fused_paged_prefill_attention``
(Pallas in interpret mode) on the same pools: survivor tables and
telemetry exact, outputs at fp32 1e-5. Edge cases mirror
``test_kernels.py::TestFusedDecodePagedEdges`` / ``TestFusedPrefillPaged``:
one mapped page, a live budget larger than the mapped pages, a survivor
on the highest physical page, and ρ ≤ 1 ⇒ dense."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode_live_budget as j_live_budget
from repro.core import quantization as jq
from repro.core.energon_attention import _prefill_diag_blocks as j_diag
from repro.kernels import mpmrf_decode as jdec
from repro.kernels import mpmrf_prefill as jpre
from repro.kernels import ops as jops
from repro_torch.core import decode_live_budget as t_live_budget
from repro_torch.core import sparse_attention as tspa
from repro_torch.core.energon_attention import _prefill_diag_blocks as t_diag
from repro_torch.kernels import mpmrf_decode as tdec
from repro_torch.kernels import mpmrf_prefill as tpre
from repro_torch.kernels import ops as tops
from repro_torch.runtime import paged_cache as tpgc
from tests._torch_port import n, t

H, G, D, BK = 2, 4, 16, 16


def _pool(k, v, tables, num_pages, bk=BK):
    """Scatter per-slot logical K/V ``[B, H, n, d]`` into a page pool
    through ``tables``; planes from the per-page quantization."""
    B, _, n_rows, d = k.shape
    kp = np.zeros((H, num_pages * bk, d), np.float32)
    vp = np.zeros_like(kp)
    for b in range(B):
        for j in range(n_rows // bk):
            pg = int(tables[b, j])
            kp[:, pg * bk:(pg + 1) * bk] = k[b, :, j * bk:(j + 1) * bk]
            vp[:, pg * bk:(pg + 1) * bk] = v[b, :, j * bk:(j + 1) * bk]
    codes, scale = jq.quantize_int16_blocks(jnp.asarray(kp), bk)
    return dict(k=kp, v=vp, codes=np.asarray(codes), scale=np.asarray(scale))


def _decode_operands(cl_rows, tables, num_pages, B=2, seed=11):
    rng = np.random.default_rng(seed)
    mb = tables.shape[1]
    n_rows = mb * BK
    q = rng.normal(size=(B, H, G, D)).astype(np.float32)
    k = rng.normal(size=(B, H, n_rows, D)).astype(np.float32)
    v = rng.normal(size=(B, H, n_rows, D)).astype(np.float32)
    cl = np.asarray(cl_rows, np.int32)
    live = (np.arange(n_rows)[None, :] < cl[:, None])[:, None, :, None]
    return q, cl, _pool(k * live, v * live, tables, num_pages)


def _run_decode(q, cl, pool, tables, budget, lb, keep_all=False):
    kw = dict(key_block=BK, block_budget=budget, keep_all=keep_all,
              telemetry=True)
    ref, ref_stats = jops.fused_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"]),
        jnp.asarray(pool["codes"]), jnp.asarray(pool["scale"]),
        jnp.asarray(tables), jnp.asarray(cl),
        live_budget=None if lb is None else jnp.asarray(lb), **kw)
    out, stats = tops.fused_paged_decode_attention(
        t(q), t(pool["k"]), t(pool["v"]), t(pool["codes"]),
        t(pool["scale"]), t(tables), t(cl),
        live_budget=None if lb is None else t(lb), **kw)
    np.testing.assert_allclose(n(out), n(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(n(stats), n(ref_stats))
    return out


def _decode_tables_equal(q, cl, pool, tables, budget, lb):
    """The survivor tables both pipelines select, step by step."""
    B = q.shape[0]
    num_pages = pool["scale"].shape[-1]
    mb = tables.shape[1]
    bh = B * H
    q16 = jq.quantize_int16(jnp.asarray(q), axis=-1)
    qp = np.asarray(q16.bit_plane(4)).reshape(bh, G, D)
    qs = np.asarray(q16.scale).reshape(bh, G, 1)
    bt = (tables[:, None, :] + np.arange(H)[None, :, None] * num_pages
          ).reshape(bh, mb).astype(np.int32)
    cl_bh = np.repeat(cl, H)
    codes = pool["codes"].reshape(H * num_pages, BK, D)
    scale = pool["scale"].reshape(H * num_pages, 1)
    js = jdec.mpmrf_paged_filter_scores(
        jnp.asarray(qp), jnp.asarray(qs), jnp.asarray(codes),
        jnp.asarray(scale), jnp.asarray(bt), jnp.asarray(cl_bh),
        key_block=BK, interpret=True)
    ts = tdec.paged_filter_scores(t(qp), t(qs), t(codes), t(scale), t(bt),
                                  t(cl_bh), key_block=BK)
    kw = dict(alphas=(0.0, 0.0), key_block=BK, block_budget=budget,
              keep_all=False, keep_first=True, keep_diagonal=True, heads=H,
              with_stats=True)
    ji = jops._fused_decode_select(*js, jnp.asarray(cl_bh),
                                   live_budget=jnp.asarray(lb), **kw)
    ti = tops._fused_decode_select(*ts, t(cl_bh), live_budget=t(lb), **kw)
    for a, b in zip(ji, ti):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("ratio", [2.0, 4.0])
def test_fused_paged_decode_matches_reference(ratio):
    num_pages, mb = 15, 6
    rng = np.random.default_rng(0)
    perm = rng.permutation(num_pages)
    tables = np.stack([perm[:mb], perm[mb:2 * mb]]).astype(np.int32)
    q, cl, pool = _decode_operands([37, 90], tables, num_pages, seed=1)
    budget = max(1, math.ceil(mb / ratio))
    lb = np.asarray(j_live_budget(jnp.asarray(cl), BK, ratio))
    np.testing.assert_array_equal(n(t_live_budget(t(cl), BK, ratio)), lb)
    _run_decode(q, cl, pool, tables, budget, lb)
    _decode_tables_equal(q, cl, pool, tables, budget, lb)


def test_decode_exactly_one_mapped_page():
    tables = np.array([[7, 0, 0, 0], [3, 0, 0, 0]], np.int32)
    q, cl, pool = _decode_operands([5, 16], tables, 9)
    lb = np.asarray(j_live_budget(jnp.asarray(cl), BK, 2.0))
    assert int(lb.max()) == 1
    _run_decode(q, cl, pool, tables, 2, lb)
    _decode_tables_equal(q, cl, pool, tables, 2, lb)


def test_decode_live_budget_exceeding_mapped_pages():
    tables = np.array([[4, 5, 0, 0], [1, 2, 6, 0]], np.int32)
    q, cl, pool = _decode_operands([20, 40], tables, 9)
    lb = np.array([4, 4], np.int32)
    _run_decode(q, cl, pool, tables, 4, lb)
    _decode_tables_equal(q, cl, pool, tables, 4, lb)


def test_decode_survivor_on_highest_physical_page():
    last = 8
    tables = np.array([[2, last, 1, 0], [last, 4, 5, 6]], np.int32)
    q, cl, pool = _decode_operands([64, 64], tables, 9)
    lb = np.asarray(j_live_budget(jnp.asarray(cl), BK, 2.0))
    _run_decode(q, cl, pool, tables, 2, lb)
    _decode_tables_equal(q, cl, pool, tables, 2, lb)


def test_decode_keep_all_is_exactly_dense():
    """ρ ≤ 1: every valid block survives and the gather is dense
    attention over the slot's logical rows."""
    num_pages, mb = 15, 6
    tables = np.random.default_rng(3).permutation(num_pages)[:2 * mb]
    tables = tables.reshape(2, mb).astype(np.int32)
    q, cl, pool = _decode_operands([50, 96], tables, num_pages, seed=4)
    out = _run_decode(q, cl, pool, tables, mb, None, keep_all=True)
    k_log = tpgc.gather_logical_rows(t(pool["k"]), t(tables), BK)
    v_log = tpgc.gather_logical_rows(t(pool["v"]), t(tables), BK)
    valid = (torch.arange(mb * BK)[None, :] < t(cl)[:, None])[:, None, None]
    dense = tspa.dense_attention(t(q), k_log, v_log, valid)
    np.testing.assert_allclose(n(out), n(dense), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

BQ = 8


def _prefill_operands(tables, num_pages, offsets, ragged, n_q=16, seed=0):
    rng = np.random.default_rng(seed)
    B, mb = tables.shape
    n_rows = mb * BK
    q = rng.normal(size=(B, H, n_q, D)).astype(np.float32)
    k = rng.normal(size=(B, H, n_rows, D)).astype(np.float32)
    v = rng.normal(size=(B, H, n_rows, D)).astype(np.float32)
    pos = np.stack([o + np.arange(n_q) for o in offsets]).astype(np.int32)
    if ragged:
        pos[1, n_q - ragged:] = n_rows
    extent = np.where(pos < n_rows, pos + 1, 0).max(axis=1)
    live = (np.arange(n_rows)[None, :] < extent[:, None])[:, None, :, None]
    return q, pos, _pool(k * live, v * live, tables, num_pages)


def _run_prefill(q, pos, pool, tables, ratio=2.0, keep_all=False):
    n_k = tables.shape[1] * BK
    budget = max(1, math.ceil(tables.shape[1] / ratio))
    common = dict(query_block=BQ, key_block=BK, block_budget=budget,
                  keep_all=keep_all, telemetry=True)
    ref, ref_stats = jops.fused_paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"]),
        jnp.asarray(pool["codes"]), jnp.asarray(pool["scale"]),
        jnp.asarray(tables), jnp.asarray(pos),
        diag_blocks=j_diag(jnp.asarray(pos), BQ, BK, n_k), **common)
    diag = t_diag(t(pos), BQ, BK, n_k)
    np.testing.assert_array_equal(
        n(diag), np.asarray(j_diag(jnp.asarray(pos), BQ, BK, n_k)))
    out, stats = tops.fused_paged_prefill_attention(
        t(q), t(pool["k"]), t(pool["v"]), t(pool["codes"]),
        t(pool["scale"]), t(tables), t(pos), diag_blocks=diag, **common)
    np.testing.assert_allclose(n(out), n(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(n(stats), n(ref_stats))
    _prefill_tables_equal(q, pos, pool, tables, budget, keep_all)
    return out


def _prefill_tables_equal(q, pos, pool, tables, budget, keep_all):
    B, mb = tables.shape
    n_q = q.shape[2]
    n_k = mb * BK
    num_pages = pool["scale"].shape[-1]
    bh = B * H
    q16 = jq.quantize_int16(jnp.asarray(q), axis=-1)
    qp = np.asarray(q16.bit_plane(4)).reshape(bh, n_q, D)
    qs = np.asarray(q16.scale).reshape(bh, n_q, 1)
    bt = (tables[:, None, :] + np.arange(H)[None, :, None] * num_pages
          ).reshape(bh, mb).astype(np.int32)
    qpos = np.repeat(pos, H, axis=0)
    codes = pool["codes"].reshape(H * num_pages, BK, D)
    scale = pool["scale"].reshape(H * num_pages, 1)
    js = jpre.mpmrf_paged_prefill_filter_scores(
        jnp.asarray(qp), jnp.asarray(qs), jnp.asarray(qpos),
        jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(bt),
        query_block=BQ, key_block=BK, interpret=True)
    ts = tpre.paged_prefill_filter_scores(
        t(qp), t(qs), t(qpos), t(codes), t(scale), t(bt),
        query_block=BQ, key_block=BK)
    kw = dict(round_bits=(2, 4), alphas=(0.0, 0.0), query_block=BQ,
              key_block=BK, block_budget=budget, keep_all=keep_all,
              keep_first=True, keep_diagonal=True, heads=H,
              with_stats=True)
    ji = jops._fused_prefill_select(
        *js, diag_blocks=j_diag(jnp.asarray(pos), BQ, BK, n_k), **kw)
    ti = tops._fused_prefill_select(
        *ts, diag_blocks=t_diag(t(pos), BQ, BK, n_k), **kw)
    for a, b in zip(ji, ti):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("ratio", [2.0, 4.0])
def test_fused_paged_prefill_matches_reference(ratio):
    num_pages, mb = 15, 6
    perm = np.random.default_rng(0).permutation(num_pages)
    tables = np.stack([perm[:mb], perm[mb:2 * mb]]).astype(np.int32)
    q, pos, pool = _prefill_operands(tables, num_pages, (24, 70), ragged=4)
    _run_prefill(q, pos, pool, tables, ratio=ratio)


def test_prefill_single_mapped_page():
    tables = np.array([[7, 0, 0, 0], [3, 0, 0, 0]], np.int32)
    q, pos, pool = _prefill_operands(tables, 9, (0, 2), ragged=10, seed=8)
    _run_prefill(q, pos, pool, tables)


def test_prefill_survivor_on_highest_physical_page():
    tables = np.array([[2, 8, 1, 0], [3, 4, 5, 6]], np.int32)
    q, pos, pool = _prefill_operands(tables, 9, (47, 30), ragged=2, seed=10)
    _run_prefill(q, pos, pool, tables)


def test_prefill_keep_all_is_exactly_dense():
    num_pages, mb = 15, 6
    perm = np.random.default_rng(5).permutation(num_pages)
    tables = np.stack([perm[:mb], perm[mb:2 * mb]]).astype(np.int32)
    q, pos, pool = _prefill_operands(tables, num_pages, (24, 70), ragged=4,
                                     seed=6)
    out = _run_prefill(q, pos, pool, tables, keep_all=True, ratio=1.0)
    n_k = mb * BK
    k_log = tpgc.gather_logical_rows(t(pool["k"]), t(tables), BK)
    v_log = tpgc.gather_logical_rows(t(pool["v"]), t(tables), BK)
    qpos = t(pos)[:, None, :, None]
    kpos = torch.arange(n_k)[None, None, None, :]
    valid = (kpos <= qpos) & (qpos < n_k)
    dense = tspa.dense_attention(t(q), k_log, v_log, valid)
    for b in range(2):
        real = pos[b] < n_k
        np.testing.assert_allclose(n(out)[b][:, real], n(dense)[b][:, real],
                                   atol=1e-5, rtol=1e-5)

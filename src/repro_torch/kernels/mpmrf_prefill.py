"""MP-MRF prefill kernels: B3 / B7 (filter) and B4 / B8 (survivor
gather), over the paged pool and over the contiguous cache.

As in :mod:`repro_torch.kernels.mpmrf_decode`: CUDA tensors launch the
kernels of ``csrc/mpmrf_prefill.cu``, CPU tensors run the plain PyTorch
versions beside them, and each contiguous twin shares its paged
sibling's kernel body and plain arithmetic. B7 takes a per-row key scale
(a prefill key tile may span several decode-block scale groups).

Ports of ``repro.kernels.mpmrf_prefill.mpmrf_paged_prefill_filter_scores``,
``paged_prefill_gather_attention``, ``mpmrf_prefill_filter_scores`` and
``prefill_gather_attention`` (the TPU Pallas kernels).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check_attention_launch
from repro_torch.kernels.mpmrf_decode import (
    FILTER_HEAD_DIMS, NEG_INF, _cache_blocks, _check_cuda, _require,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mpmrf_paged_prefill_filter_scores": [_P] * 8 + [_I] * 8 + [_P],
    "mpmrf_prefill_filter_scores": [_P] * 7 + [_I] * 8 + [_P],
    "paged_prefill_gather_attention": [_P] * 8 + [_I] * 7 + [_F, _P],
    "prefill_gather_attention": [_P] * 7 + [_I] * 7 + [_F, _P],
}


def _lib():
    return _build.load("mpmrf_prefill", _SIGNATURES)


# --------------------------------------------------------------------------
# B3: two-round prefill scores pooled per query block, off the page pool
# --------------------------------------------------------------------------


def _prefill_scores_plain(q_plane, q_scale, q_positions, codes, row_scale,
                          round_bits, query_block):
    """B3 / B7 on gathered blocks: codes int16 ``[bh, mb, bk, d]`` and
    each key row's scale ``[bh, mb, bk]`` (bit-exact, as B1's)."""
    lo, hi = round_bits
    bh, n_q, _ = q_plane.shape
    _, mb, bk, _ = codes.shape
    bq = query_block
    n_qb = n_q // bq
    n_k = mb * bk
    codes = codes.to(torch.int32)
    msb = codes >> (16 - lo)
    rem = (codes >> (16 - hi)) - (msb << (hi - lo))
    qp = q_plane.to(torch.float64)
    acc0 = torch.einsum("bqd,bjkd->bjqk", qp, msb.to(torch.float64))
    accr = torch.einsum("bqd,bjkd->bjqk", qp, rem.to(torch.float64))
    acc0 = acc0.round().to(torch.int32)
    acc1 = (acc0 << (hi - lo)) + accr.round().to(torch.int32)
    qs = (q_scale.float() * float(2 ** (16 - hi)))[:, None]   # [bh,1,n_q,1]
    ks = row_scale.float()[:, :, None, :]                     # [bh,mb,1,bk]
    s0 = (acc0.float() * qs) * (ks * float(2 ** (16 - lo)))
    s1 = (acc1.float() * qs) * (ks * float(2 ** (16 - hi)))
    kpos = (torch.arange(mb, device=qp.device)[:, None] * bk
            + torch.arange(bk, device=qp.device)[None, :])      # [mb, bk]
    qpos = q_positions.long()[:, None, :, None]                 # [bh,1,n_q,1]
    ok = (kpos[None, :, None, :] <= qpos) & (qpos < n_k)        # [bh,mb,n_q,bk]

    def pool(s):
        s = torch.where(ok, s, NEG_INF).reshape(bh, mb, n_qb, bq, bk)
        return s.amax(dim=(-2, -1)).transpose(1, 2).contiguous()

    return pool(s0), pool(s1)


def paged_prefill_filter_scores_plain(
    q_plane, q_scale, q_positions, k_codes_pages, k_page_scale, block_table,
    *, round_bits=(2, 4), query_block=128, key_block=128,
):
    """Plain PyTorch version of B3 (bit-exact, as B1's)."""
    bt = block_table.long()
    ks = k_page_scale.reshape(-1)[bt][..., None].expand(-1, -1, key_block)
    return _prefill_scores_plain(
        q_plane, q_scale, q_positions, k_codes_pages[bt], ks, round_bits,
        query_block,
    )


def paged_prefill_filter_scores(
    q_plane: torch.Tensor,
    q_scale: torch.Tensor,
    q_positions: torch.Tensor,
    k_codes_pages: torch.Tensor,
    k_page_scale: torch.Tensor,
    block_table: torch.Tensor,
    *,
    round_bits: Tuple[int, int] = (2, 4),
    query_block: int = 128,
    key_block: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-round prefill block scores pooled per query block (B3).

    q_plane int32 ``[bh, n_q, d]``; q_scale f32 ``[bh, n_q, 1]``;
    q_positions int32 ``[bh, n_q]`` (sentinels ≥ n_k); codes/scales/table
    as in B1 with page size == key_block. Returns ``(s0, s1)`` f32
    ``[bh, n_qb, mb]``.
    """
    bh, n_q, d = q_plane.shape
    _require(n_q % query_block == 0,
             f"chunk rows {n_q} not divisible by {query_block}")
    if q_plane.device.type == "cpu":
        return paged_prefill_filter_scores_plain(
            q_plane, q_scale, q_positions, k_codes_pages, k_page_scale,
            block_table, round_bits=round_bits, query_block=query_block,
            key_block=key_block,
        )
    _require(q_plane.is_cuda, f"unsupported device {q_plane.device}")
    lo, hi = round_bits
    mb = block_table.shape[-1]
    n_qb = n_q // query_block
    _require(hi <= 8 and lo < hi, "plane widths must satisfy lo < hi <= 8")
    _require(d in FILTER_HEAD_DIMS, f"head_dim {d} not in {FILTER_HEAD_DIMS}")
    _require(256 % key_block == 0, f"key_block {key_block} must divide 256")
    _require(tuple(k_codes_pages.shape[1:]) == (key_block, d),
             "k_codes_pages must be [P, key_block, d]")
    _require(q_plane.dtype == q_positions.dtype == block_table.dtype
             == torch.int32 and k_codes_pages.dtype == torch.int16,
             "dtypes: q_plane/q_positions/block_table int32, codes int16")
    q_scale = q_scale.float().contiguous()
    k_page_scale = k_page_scale.float().contiguous()
    _check_cuda(q_plane, q_scale, q_positions, k_codes_pages, k_page_scale,
                block_table)
    s0 = torch.empty((bh, n_qb, mb), dtype=torch.float32,
                     device=q_plane.device)
    s1 = torch.empty_like(s0)
    fn = _lib().mpmrf_paged_prefill_filter_scores
    _build.count_launch("mpmrf_paged_prefill_filter_scores")
    _build.check(fn(
        _build.ptr(q_plane), _build.ptr(q_scale), _build.ptr(q_positions),
        _build.ptr(k_codes_pages), _build.ptr(k_page_scale),
        _build.ptr(block_table), _build.ptr(s0), _build.ptr(s1),
        bh, n_q, d, query_block, key_block, mb, lo, hi,
        _build.stream_ptr(q_plane.device),
    ), "mpmrf_paged_prefill_filter_scores")
    return s0, s1


# --------------------------------------------------------------------------
# B4: survivor-table prefill attention over the page pool
# --------------------------------------------------------------------------


def _prefill_gather_plain(q, q_positions, k_blocks, v_blocks, block_indices,
                         block_valid, n_k, query_block, key_block, scale,
                         out_dtype):
    """B4 / B8 on each query block's gathered survivor blocks
    ``[bh, n_qb, S, bk, d]``: softmax with the kernels' per-row mask."""
    bh, n_q, d = q.shape
    bq, bk = query_block, key_block
    n_qb = n_q // bq
    sm_scale = scale if scale is not None else 1.0 / (d ** 0.5)
    idx = block_indices.long()                                  # [bh,n_qb,S]
    budget = idx.shape[-1]
    k = k_blocks.float().reshape(bh, n_qb, budget * bk, d)
    v = v_blocks.float().reshape(bh, n_qb, budget * bk, d)
    qf = q.float().reshape(bh, n_qb, bq, d)
    s = torch.matmul(qf, k.transpose(-1, -2)) * sm_scale        # [bh,n_qb,bq,S·bk]
    kpos = (idx[..., None] * bk
            + torch.arange(bk, device=q.device)).reshape(bh, n_qb, 1, -1)
    slot_ok = (block_valid[..., None] > 0).expand(-1, -1, -1, bk)
    slot_ok = slot_ok.reshape(bh, n_qb, 1, -1)
    qpos = q_positions.long().reshape(bh, n_qb, bq, 1)
    ok = slot_ok & (kpos <= qpos) & (qpos < n_k)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v) / torch.clamp(l, min=1e-30)
    return out.reshape(bh, n_q, d).to(out_dtype)


def paged_prefill_gather_attention_plain(
    q, q_positions, k_pages, v_pages, block_indices, block_valid,
    block_table, *, query_block=128, key_block=128, scale=None,
):
    """Plain PyTorch version of B4: per query block, softmax over its
    gathered survivor pages with the kernel's per-row mask."""
    n_qb = q.shape[1] // query_block
    pages = torch.gather(
        block_table.long()[:, None, :].expand(-1, n_qb, -1), 2,
        block_indices.long(),
    )
    return _prefill_gather_plain(
        q, q_positions, k_pages[pages], v_pages[pages], block_indices,
        block_valid, block_table.shape[-1] * key_block, query_block,
        key_block, scale, v_pages.dtype,
    )


def paged_prefill_gather_attention(
    q: torch.Tensor,
    q_positions: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_indices: torch.Tensor,
    block_valid: torch.Tensor,
    block_table: torch.Tensor,
    *,
    query_block: int = 128,
    key_block: int = 128,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Two-level survivor-table prefill attention (B4).

    q ``[bh, n_q, d]``; q_positions int32 ``[bh, n_q]``; K/V pages
    ``[P, bk, d]``; block_indices / block_valid int32
    ``[bh, n_qb, budget]``; block_table int32 ``[bh, mb]``. Returns
    ``[bh, n_q, d]`` in V's dtype (sentinel rows are zeros).
    """
    bh, n_q, d = q.shape
    _require(n_q % query_block == 0,
             f"chunk rows {n_q} not divisible by {query_block}")
    if q.device.type == "cpu":
        return paged_prefill_gather_attention_plain(
            q, q_positions, k_pages, v_pages, block_indices, block_valid,
            block_table, query_block=query_block, key_block=key_block,
            scale=scale,
        )
    budget = block_indices.shape[-1]
    mb = block_table.shape[-1]
    # the kept survivor lists: two ids per slot, a count and the
    # block's largest live position
    check_attention_launch(q, k_pages, v_pages, query_block, key_block,
                           2 * budget + 1, rows_of_q=False)
    _require(tuple(k_pages.shape[1:]) == (key_block, d),
             "K/V pages must be [P, key_block, d]")
    _require(q_positions.dtype == block_indices.dtype == block_valid.dtype
             == block_table.dtype == torch.int32, "index operands are int32")
    _check_cuda(q, q_positions, k_pages, v_pages, block_indices, block_valid,
                block_table)
    sm_scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    fn = _lib().paged_prefill_gather_attention
    _build.count_launch("paged_prefill_gather_attention")
    _build.check(fn(
        _build.ptr(q), _build.ptr(q_positions), _build.ptr(k_pages),
        _build.ptr(v_pages), _build.ptr(block_indices),
        _build.ptr(block_valid), _build.ptr(block_table), _build.ptr(out),
        bh, n_q, d, query_block, key_block, budget, mb, float(sm_scale),
        _build.stream_ptr(q.device),
    ), "paged_prefill_gather_attention")
    return out


# --------------------------------------------------------------------------
# B7: prefill scores pooled per query block, off the contiguous codes
# --------------------------------------------------------------------------


def mpmrf_prefill_filter_scores_plain(
    q_plane, q_scale, q_positions, k_codes, k_row_scale, *,
    round_bits=(2, 4), query_block=128, key_block=128,
):
    """Plain PyTorch version of B7 (bit-exact, B3's arithmetic with each
    key row's own scale)."""
    return _prefill_scores_plain(
        q_plane, q_scale, q_positions, _cache_blocks(k_codes, key_block),
        _cache_blocks(k_row_scale, key_block), round_bits, query_block,
    )


def mpmrf_prefill_filter_scores(
    q_plane: torch.Tensor,
    q_scale: torch.Tensor,
    q_positions: torch.Tensor,
    k_codes: torch.Tensor,
    k_row_scale: torch.Tensor,
    *,
    round_bits: Tuple[int, int] = (2, 4),
    query_block: int = 128,
    key_block: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-round prefill block scores pooled per query block, off the
    contiguous cache (B7).

    q_plane int32 ``[bh, n_q, d]``; q_scale f32 ``[bh, n_q, 1]``;
    q_positions int32 ``[bh, n_q]`` (sentinels ≥ n_k); k_codes int16
    ``[bh, n_k, d]``; k_row_scale f32 ``[bh, n_k]`` (each key row's
    dequantization scale). Returns ``(s0, s1)`` f32 ``[bh, n_qb, n_kb]``.
    """
    bh, n_q, d = q_plane.shape
    _require(n_q % query_block == 0,
             f"chunk rows {n_q} not divisible by {query_block}")
    if q_plane.device.type == "cpu":
        return mpmrf_prefill_filter_scores_plain(
            q_plane, q_scale, q_positions, k_codes, k_row_scale,
            round_bits=round_bits, query_block=query_block,
            key_block=key_block,
        )
    _require(q_plane.is_cuda, f"unsupported device {q_plane.device}")
    lo, hi = round_bits
    n_k = k_codes.shape[-2]
    _require(n_k % key_block == 0,
             f"cache rows {n_k} not divisible by {key_block}")
    n_kb, n_qb = n_k // key_block, n_q // query_block
    _require(hi <= 8 and lo < hi, "plane widths must satisfy lo < hi <= 8")
    _require(d in FILTER_HEAD_DIMS, f"head_dim {d} not in {FILTER_HEAD_DIMS}")
    _require(256 % key_block == 0, f"key_block {key_block} must divide 256")
    _require(tuple(k_codes.shape) == (bh, n_k, d)
             and tuple(k_row_scale.shape) == (bh, n_k),
             "k_codes must be [bh, n_k, d] and k_row_scale [bh, n_k]")
    _require(q_plane.dtype == q_positions.dtype == torch.int32
             and k_codes.dtype == torch.int16,
             "dtypes: q_plane/q_positions int32, codes int16")
    q_scale = q_scale.float().contiguous()
    k_row_scale = k_row_scale.float().contiguous()
    _check_cuda(q_plane, q_scale, q_positions, k_codes, k_row_scale)
    s0 = torch.empty((bh, n_qb, n_kb), dtype=torch.float32,
                     device=q_plane.device)
    s1 = torch.empty_like(s0)
    fn = _lib().mpmrf_prefill_filter_scores
    _build.count_launch("mpmrf_prefill_filter_scores")
    _build.check(fn(
        _build.ptr(q_plane), _build.ptr(q_scale), _build.ptr(q_positions),
        _build.ptr(k_codes), _build.ptr(k_row_scale), _build.ptr(s0),
        _build.ptr(s1), bh, n_q, d, query_block, key_block, n_kb, lo, hi,
        _build.stream_ptr(q_plane.device),
    ), "mpmrf_prefill_filter_scores")
    return s0, s1


# --------------------------------------------------------------------------
# B8: survivor-table prefill attention over the contiguous cache
# --------------------------------------------------------------------------


def prefill_gather_attention_plain(
    q, q_positions, k_cache, v_cache, block_indices, block_valid, *,
    query_block=128, key_block=128, scale=None,
):
    """Plain PyTorch version of B8 (B4's arithmetic on the contiguous
    cache's survivor blocks)."""
    rows = torch.arange(q.shape[0], device=q.device)[:, None, None]
    idx = block_indices.long()
    return _prefill_gather_plain(
        q, q_positions, _cache_blocks(k_cache, key_block)[rows, idx],
        _cache_blocks(v_cache, key_block)[rows, idx], block_indices,
        block_valid, k_cache.shape[-2], query_block, key_block, scale,
        v_cache.dtype,
    )


def prefill_gather_attention(
    q: torch.Tensor,
    q_positions: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_indices: torch.Tensor,
    block_valid: torch.Tensor,
    *,
    query_block: int = 128,
    key_block: int = 128,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Survivor-table prefill attention over the contiguous cache (B8).

    q ``[bh, n_q, d]``; q_positions int32 ``[bh, n_q]``; K/V caches
    ``[bh, n_k, d]``; block_indices / block_valid int32
    ``[bh, n_qb, budget]``. Returns ``[bh, n_q, d]`` in V's dtype
    (sentinel rows are zeros).
    """
    bh, n_q, d = q.shape
    _require(n_q % query_block == 0,
             f"chunk rows {n_q} not divisible by {query_block}")
    if q.device.type == "cpu":
        return prefill_gather_attention_plain(
            q, q_positions, k_cache, v_cache, block_indices, block_valid,
            query_block=query_block, key_block=key_block, scale=scale,
        )
    n_k = k_cache.shape[-2]
    budget = block_indices.shape[-1]
    # the kept survivor lists: two ids per slot, a count and the
    # block's largest live position
    check_attention_launch(q, k_cache, v_cache, query_block, key_block,
                           2 * budget + 1, rows_of_q=False)
    _require(n_k % key_block == 0,
             f"key_block {key_block} must divide the {n_k} cache rows")
    _require(tuple(k_cache.shape) == tuple(v_cache.shape) == (bh, n_k, d),
             "K/V caches must be [bh, n_k, d]")
    _require(q_positions.dtype == block_indices.dtype == block_valid.dtype
             == torch.int32, "index operands are int32")
    _check_cuda(q, q_positions, k_cache, v_cache, block_indices, block_valid)
    sm_scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    fn = _lib().prefill_gather_attention
    _build.count_launch("prefill_gather_attention")
    _build.check(fn(
        _build.ptr(q), _build.ptr(q_positions), _build.ptr(k_cache),
        _build.ptr(v_cache), _build.ptr(block_indices),
        _build.ptr(block_valid), _build.ptr(out),
        bh, n_q, d, query_block, key_block, budget, n_k // key_block,
        float(sm_scale), _build.stream_ptr(q.device),
    ), "prefill_gather_attention")
    return out

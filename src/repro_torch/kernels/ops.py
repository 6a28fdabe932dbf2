"""Fused paged Energon attention: filter kernel → selection → gather
kernel (port of the paged half of ``repro.kernels.ops``).

The pipeline quantizes the folded query rows, scores every logical key
block straight off the pool's resident int16 codes (B1 / B3), runs the
Eq. 3 thresholds and budget selection on the small block-score planes
through the one torch implementation of each rule
(:mod:`repro_torch.core.filtering`), and gathers only the survivor
pages of K and V (B2 / B4). Both kernels address the pool through the
block table, offset per KV head: the pools fold the KV-head axis into
the page axis (``[KV, P·ps, d]`` → ``[KV·P, ps, d]``), so row ``b·KV+h``
of the table reads ``table[b] + h·P``.

The reference's ``shard_map`` tensor-parallel branch waits for a later
slice of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import filtering as flt
from repro_torch.core import quantization as qlib
from repro_torch.kernels import mpmrf_decode as dec_kernel
from repro_torch.kernels import mpmrf_prefill as pre_kernel

NEG_INF = -1e30


def _head_offset_table(
    block_table: torch.Tensor, heads: int, num_pages: int
) -> torch.Tensor:
    """``[B, mb]`` logical→physical table → ``[B·KV, mb]`` with each KV
    head's copy of the slot's pages."""
    head_off = torch.arange(
        heads, dtype=torch.int32, device=block_table.device
    ) * num_pages
    bt = block_table.to(torch.int32)[:, None, :] + head_off[None, :, None]
    return bt.reshape(-1, block_table.shape[-1])


def _fused_decode_select(
    s0, s1, cl_bh, *, alphas, key_block, block_budget, keep_all,
    keep_first, keep_diagonal, live_budget, heads, with_stats=False,
):
    """Eq. 3 thresholds + exact-budget tier selection on the ``[bh,
    n_kb]`` block-max planes. Returns ``(idx, val, stats_or_None)``."""
    blk_valid = s0 > NEG_INF / 2
    keep = blk_valid
    if not keep_all:
        theta0 = flt.eq3_threshold(s0, alphas[0], keep)
        keep = keep & (s0 >= theta0)
        theta1 = flt.eq3_threshold(s1, alphas[1], keep)
        keep = keep & (s1 >= theta1)
    newest = (cl_bh - 1) // key_block
    lb_bh = None
    if live_budget is not None:
        lb_bh = live_budget.to(torch.int32).repeat_interleave(heads)
    if with_stats:
        idx, val, sel_tier = flt.decode_block_tier_select(
            s1, keep, blk_valid, newest, block_budget,
            keep_first=keep_first, keep_diagonal=keep_diagonal,
            live_budget=lb_bh, with_tiers=True,
        )
        stats = flt.selection_stats(flt.FilterResult(
            keep_mask=keep, block_indices=idx, scores=s1, block_valid=val,
            sel_tier=sel_tier, live_mask=blk_valid,
        ))
        return idx, val, stats
    idx, val = flt.decode_block_tier_select(
        s1, keep, blk_valid, newest, block_budget,
        keep_first=keep_first, keep_diagonal=keep_diagonal,
        live_budget=lb_bh,
    )
    return idx, val, None


def fused_paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_codes: torch.Tensor,
    k_scale: torch.Tensor,
    block_table: torch.Tensor,
    cache_length: torch.Tensor,
    *,
    round_bits: Tuple[int, ...] = (2, 4),
    alphas: Tuple[float, ...] = (0.0, 0.0),
    key_block: int = 64,
    block_budget: int = 8,
    keep_all: bool = False,
    keep_first: bool = True,
    keep_diagonal: bool = True,
    live_budget: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    telemetry: bool = False,
):
    """Fused decode over the shared page pool (B1 → selection → B2).

    q ``[B, KV, G, d]``; k_pool/v_pool/k_codes ``[KV, pool_rows, d]``;
    k_scale f32 ``[KV, num_pages]``; block_table int32 ``[B, mb]``;
    cache_length int32 ``[B]``; live_budget optional int32 ``[B]``.
    Returns ``[B, KV, G, d]`` (V's dtype); with ``telemetry`` also int32
    ``[B, 4]`` selection stats summed over heads.
    """
    if len(round_bits) != 2:
        raise ValueError("fused decode kernel supports 2-round configs")
    batch, heads, g, d = q.shape
    bk = key_block
    num_pages = k_pool.shape[-2] // bk
    bh = batch * heads

    q16 = qlib.quantize_int16(q, axis=-1)
    qp = q16.bit_plane(round_bits[-1]).reshape(bh, g, d)
    qs = q16.scale.reshape(bh, g, 1)
    cl_bh = cache_length.to(torch.int32).repeat_interleave(heads)
    bt_bh = _head_offset_table(block_table, heads, num_pages)

    s0, s1 = dec_kernel.paged_filter_scores(
        qp, qs,
        k_codes.reshape(heads * num_pages, bk, d),
        k_scale.reshape(heads * num_pages, 1),
        bt_bh, cl_bh, round_bits=tuple(round_bits), key_block=bk,
    )
    idx, val, stats = _fused_decode_select(
        s0, s1, cl_bh,
        alphas=alphas, key_block=bk, block_budget=block_budget,
        keep_all=keep_all, keep_first=keep_first,
        keep_diagonal=keep_diagonal, live_budget=live_budget, heads=heads,
        with_stats=telemetry,
    )
    out = dec_kernel.paged_decode_gather_attention(
        q.reshape(bh, g, d).contiguous(),
        k_pool.reshape(heads * num_pages, bk, d),
        v_pool.reshape(heads * num_pages, bk, d),
        idx, val, bt_bh, cl_bh, key_block=bk, scale=scale,
    ).reshape(batch, heads, g, d)
    if telemetry:
        return out, stats.reshape(batch, heads, 4).sum(1, dtype=torch.int32)
    return out


def _fused_prefill_select(
    s0, s1, *, round_bits, alphas, query_block, key_block, block_budget,
    keep_all, keep_first, keep_diagonal, diag_blocks, heads,
    with_stats=False,
):
    """Eq. 3 rounds + safeguards + top-B on the ``[bh, n_qb, n_kb]``
    planes, through the shared prefill selection rule."""
    n_kb = s0.shape[-1]
    mcfg = flt.MPMRFConfig(
        round_bits=tuple(round_bits), alphas=tuple(alphas),
        granularity="block", query_block=query_block, key_block=key_block,
        block_budget=block_budget, keep_first=keep_first,
        keep_diagonal=keep_diagonal, reuse_partial=True, keep_all=keep_all,
    )
    diag_mask = None
    if keep_diagonal and diag_blocks is not None:
        db = diag_blocks.to(torch.int32).repeat_interleave(heads, dim=0)
        diag_mask = flt.one_hot_bool(torch.clamp(db, 0, n_kb - 1), n_kb)
    res = flt.prefill_block_select_from_planes(
        [s0, s1], s0 > NEG_INF / 2, mcfg, diag_mask=diag_mask,
        with_stats=with_stats,
    )
    stats = flt.selection_stats(res) if with_stats else None
    return res.block_indices, res.block_valid, stats


def fused_paged_prefill_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_codes: torch.Tensor,
    k_scale: torch.Tensor,
    block_table: torch.Tensor,
    q_positions: torch.Tensor,
    *,
    round_bits: Tuple[int, ...] = (2, 4),
    alphas: Tuple[float, ...] = (0.0, 0.0),
    query_block: int = 128,
    key_block: int = 128,
    block_budget: int = 8,
    keep_all: bool = False,
    keep_first: bool = True,
    keep_diagonal: bool = True,
    diag_blocks: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    telemetry: bool = False,
):
    """Fused prefill over the shared page pool (B3 → selection → B4).

    q ``[B, KV, n_q, d]`` folded chunk rows; pools as in
    :func:`fused_paged_decode_attention` with page size == key_block;
    q_positions int32 ``[B, n_q]``; diag_blocks optional int32
    ``[B, n_qb]``. Returns ``[B, KV, n_q, d]``; with ``telemetry`` also
    int32 ``[B, 4]`` stats summed over heads and query blocks.
    """
    if len(round_bits) != 2:
        raise ValueError("fused prefill kernel supports 2-round configs")
    batch, heads, n_q, d = q.shape
    bk = key_block
    num_pages = k_pool.shape[-2] // bk
    bh = batch * heads

    q16 = qlib.quantize_int16(q, axis=-1)
    qp = q16.bit_plane(round_bits[-1]).reshape(bh, n_q, d)
    qs = q16.scale.reshape(bh, n_q, 1)
    qpos_bh = q_positions.to(torch.int32).repeat_interleave(heads, dim=0)
    bt_bh = _head_offset_table(block_table, heads, num_pages)

    s0, s1 = pre_kernel.paged_prefill_filter_scores(
        qp, qs, qpos_bh,
        k_codes.reshape(heads * num_pages, bk, d),
        k_scale.reshape(heads * num_pages, 1),
        bt_bh, round_bits=tuple(round_bits), query_block=query_block,
        key_block=bk,
    )
    idx, val, stats = _fused_prefill_select(
        s0, s1, round_bits=round_bits, alphas=alphas,
        query_block=query_block, key_block=bk, block_budget=block_budget,
        keep_all=keep_all, keep_first=keep_first,
        keep_diagonal=keep_diagonal, diag_blocks=diag_blocks, heads=heads,
        with_stats=telemetry,
    )
    out = pre_kernel.paged_prefill_gather_attention(
        q.reshape(bh, n_q, d).contiguous(), qpos_bh,
        k_pool.reshape(heads * num_pages, bk, d),
        v_pool.reshape(heads * num_pages, bk, d),
        idx, val, bt_bh, query_block=query_block, key_block=bk, scale=scale,
    ).reshape(batch, heads, n_q, d)
    if telemetry:
        return out, stats.reshape(batch, heads, 4).sum(1, dtype=torch.int32)
    return out

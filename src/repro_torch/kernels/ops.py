"""The Energon kernel pipelines (port of ``repro.kernels.ops``).

The full-sequence half composes the attention-level kernels: per-row q
and per-head k quantization, the two-round filter (B9) over int8 planes,
the deferred k-scale rescale, Eq. 3 rounds and top-B in torch, then
block-sparse attention over the survivors (B10); dense flash attention
(B11) is the unpruned baseline, and :func:`energon_block_attention`
makes the pipeline differentiable.

The serving half is the fused path: filter kernel → selection →
gather kernel, over the paged pool or the contiguous cache.

The pipeline quantizes the folded query rows, scores every logical key
block straight off the resident int16 codes (B1 / B3 paged, B5 / B7
contiguous), runs the Eq. 3 thresholds and budget selection on the
small block-score planes through the one torch implementation of each
rule (:mod:`repro_torch.core.filtering`, shared by both layouts), and
gathers only the survivor blocks of K and V (B2 / B4, B6 / B8). The
paged kernels address the pool through the block table, offset per KV
head: the pools fold the KV-head axis into the page axis
(``[KV, P·ps, d]`` → ``[KV·P, ps, d]``), so row ``b·KV+h`` of the table
reads ``table[b] + h·P``. The contiguous kernels read
``[B·KV, n_k, d]`` directly.

Tensor parallelism (the reference's ``shard_map`` branch): under an
active serve mesh whose model axis M > 1 divides the KV heads
(:func:`_tp_mesh`), the fused paged ops run their shard-local core once
per shard — shard s gets q's KV-head group s and its slice of the pools
(a head-sharded pool's own shard) on model-axis device s, the block
table and lengths copied there — and concatenate the outputs over heads
on q's device (the reference's ``all_gather``) and add the selection
stats (its ``psum``: integer counts, so exact). Each (slot, KV head) row
of the kernels and of the selection is independent of the others, so
the sharded call gives the unsharded one's bits.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import filtering as flt
from repro_torch.core import quantization as qlib
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import _build
from repro_torch.kernels import block_sparse_attention as bsa_kernel
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import mpmrf_decode as dec_kernel
from repro_torch.kernels import mpmrf_filter as filt_kernel
from repro_torch.kernels import mpmrf_prefill as pre_kernel

NEG_INF = -1e30


def _launch(name: str, kernel, *args, **kw):
    """Every kernel call of the pipelines below: ``kernel(*args, **kw)``
    (B1–B11 by their ``_build.launch_counts`` name). An op-cost walk
    (:mod:`repro_torch.analysis.op_costs`) sets ``_build.cost_hook`` for
    its duration, and the hook then prices the launch from its shapes
    and makes the call itself."""
    hook = _build.cost_hook
    if hook is None:
        return kernel(*args, **kw)
    return hook(name, kernel, args, kw)


def _tp_mesh(kv_heads: int):
    """The active serve mesh, iff the fused paged ops should run per
    shard over its 'model' axis: M > 1 and dividing the KV heads — the
    condition under which :func:`~repro_torch.distributed.sharding.
    paged_pool_spec` shards the pools by head. (Where it shards page
    rows the port keeps the pool whole, and the ops run unsharded, as
    the reference's do.)"""
    mesh = shd.get_active_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return None
    tp = mesh.shape["model"]
    if tp <= 1 or kv_heads % tp:
        return None
    return mesh


def _over_kv_shards(core, q, pools, replicated, telemetry, **kw):
    """``core(q, *pools, *replicated, **kw) -> (out, stats_or_None)`` on
    the whole pool, or once per model-axis shard under :func:`_tp_mesh`:
    q's KV-head group and the pools' head slice (a tuple leaf's own
    shard) on the shard's device, the replicated operands copied there;
    outputs concatenated over heads on q's device, stats summed."""
    mesh = _tp_mesh(q.shape[1])
    sharded = [isinstance(p, tuple) for p in pools]
    if mesh is None:
        if any(sharded):
            raise ValueError(
                "a head-sharded pool needs its serve mesh active "
                "(repro_torch.distributed.sharding.active_mesh)")
        out, stats = core(q, *pools, *replicated, **kw)
        return (out, stats) if telemetry else out
    devices = mesh.rows[0]
    m = len(devices)
    if any(len(p) != m for p, sh in zip(pools, sharded) if sh):
        raise ValueError(f"pool shards do not match the mesh's {m} "
                         "model-axis devices")
    per = q.shape[1] // m
    outs, total = [], None
    for s in range(m):
        heads = slice(s * per, (s + 1) * per)
        parts = [p[s] if sh else p[heads].to(devices[s])
                 for p, sh in zip(pools, sharded)]
        dev = parts[0].device
        out, stats = core(
            q[:, heads].to(dev), *parts,
            *(None if r is None else r.to(dev) for r in replicated), **kw)
        outs.append(out.to(q.device))
        if stats is not None:
            stats = stats.to(q.device)
            total = stats if total is None else total + stats
    out = torch.cat(outs, dim=1)
    return (out, total) if telemetry else out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Dense flash attention over ``[bh, n, d]`` operands (B11)."""
    return _launch(
        "flash_attention", fa_kernel.flash_attention,
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        q_offset=q_offset, scale=scale, block_q=block_q, block_k=block_k,
    )


def full_sequence_planes(q: torch.Tensor, k: torch.Tensor,
                         round_bits: Tuple[int, ...] = (2, 4)):
    """B9's operands: per-row q and per-head k int16 quantization, the
    q plane at the final round's width and the k MSB / remainder planes
    as int8. Returns ``(q_plane, k_msb, k_rem, q_scale, k_scale)`` with
    q_scale f32 ``[bh, n_q, 1]`` and k_scale f32 ``[bh, 1, 1]``."""
    lo, hi = round_bits
    q16 = qlib.quantize_int16(q, axis=-1)
    k16 = qlib.quantize_int16(k, axis=(-2, -1))
    return (q16.bit_plane(hi).to(torch.int8),
            k16.bit_plane(lo).to(torch.int8),
            k16.lsb_remainder(lo, hi).to(torch.int8),
            q16.scale, k16.scale)


def select_from_scores(
    s0: torch.Tensor,
    s1: torch.Tensor,
    k_scale: torch.Tensor,
    *,
    round_bits: Tuple[int, ...] = (2, 4),
    alphas: Tuple[float, ...] = (0.0, 0.0),
    block_budget: int = 8,
    query_block: int = 128,
    key_block: int = 128,
    keep_first: bool = True,
    keep_diagonal: bool = True,
    keep_all: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9's block maxima → survivor table: the deferred rescale, two
    Eq. 3 rounds (none with ``keep_all``: ρ ≤ 1 keeps every valid block,
    as the chunked path's selection does; the direct path never sets
    it), the keep-first / diagonal pins and top-B."""
    lo, hi = round_bits
    n_qb, n_kb = s0.shape[-2:]
    # factors deferred from the kernel, in the reference's order: the
    # per-head k scale × the q plane's 2^(16-hi) × the round's 2^(16-bits)
    q_plane_factor = float(2 ** (16 - hi))
    s0 = torch.where(s0 <= NEG_INF / 2, NEG_INF,
                     s0 * k_scale * q_plane_factor * float(2 ** (16 - lo)))
    s1 = torch.where(s1 <= NEG_INF / 2, NEG_INF,
                     s1 * k_scale * q_plane_factor * float(2 ** (16 - hi)))

    blk_valid = s0 > NEG_INF / 2
    keep = blk_valid
    if not keep_all:
        keep = keep & (s0 >= flt.eq3_threshold(s0, alphas[0], keep))
        keep = keep & (s1 >= flt.eq3_threshold(s1, alphas[1], keep))
    if keep_first:
        keep = keep.clone()
        keep[..., 0] = blk_valid[..., 0]
    if keep_diagonal:
        diag = torch.clamp(
            (torch.arange(n_qb, device=s0.device) * query_block) // key_block,
            max=n_kb - 1)
        keep = keep | (flt.one_hot_bool(diag, n_kb) & blk_valid)

    sel = torch.where(keep, s1, NEG_INF)
    top_vals, block_indices = flt.top_k_stable(sel, min(block_budget, n_kb))
    block_valid = (top_vals > NEG_INF / 2).to(torch.int32)
    block_indices = torch.where(block_valid > 0, block_indices, 0)
    return block_indices.to(torch.int32), block_valid


def mpmrf_select_blocks(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    round_bits: Tuple[int, ...] = (2, 4),
    alphas: Tuple[float, ...] = (0.0, 0.0),
    block_budget: int = 8,
    query_block: int = 128,
    key_block: int = 128,
    causal: bool = True,
    q_offset: int = 0,
    keep_first: bool = True,
    keep_diagonal: bool = True,
    keep_all: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Filtering Unit: quantize → B9 → block selection.

    q/k float ``[bh, n, d]``. Returns ``(block_indices, block_valid)``,
    each int32 ``[bh, n_qb, B]`` with B = min(block_budget, n_kb):
    top-B of the final round's scores among the Eq. 3 survivors (lower
    index first on ties), padded slots pointing at block 0.
    """
    if len(round_bits) != 2:
        raise ValueError("the filter kernel takes the 2-round config")
    q_plane, k_msb, k_rem, q_scale, k_scale = full_sequence_planes(
        q, k, round_bits)
    s0, s1 = _launch(
        "mpmrf_filter_scores", filt_kernel.mpmrf_filter_scores, q_plane, k_msb, k_rem, q_scale, shift=round_bits[1] - round_bits[0],
        query_block=query_block, key_block=key_block, causal=causal,
        q_offset=q_offset,
    )
    return select_from_scores(
        s0, s1, k_scale, round_bits=round_bits, alphas=alphas,
        block_budget=block_budget, query_block=query_block,
        key_block=key_block, keep_first=keep_first,
        keep_diagonal=keep_diagonal, keep_all=keep_all,
    )


def block_sparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_indices: torch.Tensor,
    block_valid: Optional[torch.Tensor] = None,
    *,
    query_block: int = 128,
    key_block: int = 128,
    causal: bool = True,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The Attention Unit over ``[bh, n, d]`` operands (B10)."""
    if block_valid is None:
        block_valid = torch.ones_like(block_indices, dtype=torch.int32)
    return _launch(
        "block_sparse_attention", bsa_kernel.block_sparse_attention,
        q.contiguous(), k.contiguous(), v.contiguous(),
        block_indices.to(torch.int32).contiguous(),
        block_valid.to(torch.int32).contiguous(),
        query_block=query_block, key_block=key_block, causal=causal,
        q_offset=q_offset, scale=scale,
    )


class _EnergonBlockAttention(torch.autograd.Function):
    """B9 → selection → B10 forward; the backward recomputes through the
    plain block-sparse attention with the saved selection, as the
    reference's ``_eba_bwd`` does through ``block_sparse_attention_ref``
    (selection itself is not differentiated; the reference has no
    backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, block_budget, query_block, key_block, causal):
        idx, val = mpmrf_select_blocks(
            q, k, block_budget=block_budget, query_block=query_block,
            key_block=key_block, causal=causal,
        )
        out = block_sparse_attention(
            q, k, v, idx, val, query_block=query_block, key_block=key_block,
            causal=causal,
        )
        ctx.save_for_backward(q, k, v, idx, val)
        ctx.blocks = (query_block, key_block, causal)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, idx, val = ctx.saved_tensors
        query_block, key_block, causal = ctx.blocks
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = bsa_kernel.block_sparse_attention_plain(
                *leaves, idx, val, query_block=query_block,
                key_block=key_block, causal=causal,
            )
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None, None)


def energon_block_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_budget: int = 8,
    query_block: int = 128,
    key_block: int = 128,
    causal: bool = True,
) -> torch.Tensor:
    """End-to-end Energon attention (FU kernel + AU kernel) over
    ``[bh, n, d]`` operands, differentiable in q, k and v."""
    return _EnergonBlockAttention.apply(
        q, k, v, block_budget, query_block, key_block, causal
    )


def chunked_block_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    round_bits: Tuple[int, ...] = (2, 4),
    alphas: Tuple[float, ...] = (0.0, 0.0),
    pruning_ratio: float = 4.0,
    query_block: int = 128,
    key_block: int = 128,
    causal: bool = True,
    q_offset: int = 0,
    keep_first: bool = True,
    keep_diagonal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The chunked path's block pipeline through the kernels: B9 →
    selection (``keep_all`` at ρ ≤ 1) → B10 over ``[bh, n, d]``, the
    same survivor table as ``core.chunked_attention``'s scan and the
    same attention without any ``[n_q, n_k]`` tensor."""
    n_kb = k.shape[-2] // key_block
    idx, val = mpmrf_select_blocks(
        q, k, round_bits=round_bits, alphas=alphas,
        block_budget=max(1, math.ceil(n_kb / pruning_ratio)),
        query_block=query_block, key_block=key_block, causal=causal,
        q_offset=q_offset, keep_first=keep_first,
        keep_diagonal=keep_diagonal, keep_all=pruning_ratio <= 1.0,
    )
    return block_sparse_attention(
        q, k, v, idx, val, query_block=query_block, key_block=key_block,
        causal=causal, q_offset=q_offset, scale=scale,
    )


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
    k_pool,
    v_pool,
    k_codes,
    k_scale,
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
    k_scale f32 ``[KV, num_pages]`` (each pool leaf whole, or under an
    active mesh a tuple of its head shards); block_table int32
    ``[B, mb]``; cache_length int32 ``[B]``; live_budget optional int32
    ``[B]``. Returns ``[B, KV, G, d]`` (V's dtype); with ``telemetry``
    also int32 ``[B, 4]`` selection stats summed over heads. Under a
    tensor-parallel mesh, one :func:`_paged_decode_core` per shard.
    """
    if len(round_bits) != 2:
        raise ValueError("fused decode kernel supports 2-round configs")
    return _over_kv_shards(
        _paged_decode_core, q, (k_pool, v_pool, k_codes, k_scale),
        (block_table, cache_length, live_budget), telemetry,
        round_bits=tuple(round_bits), alphas=tuple(alphas),
        key_block=key_block, block_budget=block_budget, keep_all=keep_all,
        keep_first=keep_first, keep_diagonal=keep_diagonal, scale=scale,
        with_stats=telemetry,
    )


def _paged_decode_core(
    q, k_pool, v_pool, k_codes, k_scale, block_table, cache_length,
    live_budget, *, round_bits, alphas, key_block, block_budget, keep_all,
    keep_first, keep_diagonal, scale, with_stats,
):
    """Shard-local fused paged decode: the pipeline of
    :func:`fused_paged_decode_attention` over whatever KV-head slice of
    the pools it is given (the whole pools on one device). Returns
    ``(out, stats_or_None)``."""
    batch, heads, g, d = q.shape
    bk = key_block
    num_pages = k_pool.shape[-2] // bk
    bh = batch * heads

    q16 = qlib.quantize_int16(q, axis=-1)
    qp = q16.bit_plane(round_bits[-1]).reshape(bh, g, d)
    qs = q16.scale.reshape(bh, g, 1)
    cl_bh = cache_length.to(torch.int32).repeat_interleave(heads)
    bt_bh = _head_offset_table(block_table, heads, num_pages)

    s0, s1 = _launch(
        "mpmrf_paged_filter_scores", dec_kernel.paged_filter_scores, qp, qs,
        k_codes.reshape(heads * num_pages, bk, d),
        k_scale.reshape(heads * num_pages, 1),
        bt_bh, cl_bh, round_bits=round_bits, key_block=bk,
    )
    idx, val, stats = _fused_decode_select(
        s0, s1, cl_bh,
        alphas=alphas, key_block=bk, block_budget=block_budget,
        keep_all=keep_all, keep_first=keep_first,
        keep_diagonal=keep_diagonal, live_budget=live_budget, heads=heads,
        with_stats=with_stats,
    )
    out = _launch(
        "paged_decode_gather_attention",
        dec_kernel.paged_decode_gather_attention, q.reshape(bh, g, d).contiguous(),
        k_pool.reshape(heads * num_pages, bk, d),
        v_pool.reshape(heads * num_pages, bk, d),
        idx, val, bt_bh, cl_bh, key_block=bk, scale=scale,
    ).reshape(batch, heads, g, d)
    if with_stats:
        stats = stats.reshape(batch, heads, 4).sum(1, dtype=torch.int32)
    return out, stats


def fused_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_codes: torch.Tensor,
    k_block_scale: torch.Tensor,
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
    """Fused decode over the contiguous cache (B5 → selection → B6).

    q ``[B, KV, G, d]``; k_cache/v_cache/k_codes ``[B, KV, n_k, d]``;
    k_block_scale f32 ``[B, KV, n_kb]``; cache_length int32 ``[B]``
    (an idle slot's ``max_len + 1`` sentinel masks nothing);
    live_budget optional int32 ``[B]``. Returns ``[B, KV, G, d]`` (V's
    dtype); with ``telemetry`` also int32 ``[B, 4]`` selection stats
    summed over heads.
    """
    if len(round_bits) != 2:
        raise ValueError("fused decode kernel supports 2-round configs")
    batch, heads, g, d = q.shape
    n_k = k_cache.shape[-2]
    bk = key_block
    bh = batch * heads

    q16 = qlib.quantize_int16(q, axis=-1)
    qp = q16.bit_plane(round_bits[-1]).reshape(bh, g, d)
    qs = q16.scale.reshape(bh, g, 1)
    cl_bh = cache_length.to(torch.int32).repeat_interleave(heads)

    s0, s1 = _launch(
        "mpmrf_decode_filter_scores", dec_kernel.mpmrf_decode_filter_scores,
        qp, qs, k_codes.reshape(bh, n_k, d),
        k_block_scale.reshape(bh, n_k // bk), cl_bh,
        round_bits=tuple(round_bits), key_block=bk,
    )
    idx, val, stats = _fused_decode_select(
        s0, s1, cl_bh,
        alphas=alphas, key_block=bk, block_budget=block_budget,
        keep_all=keep_all, keep_first=keep_first,
        keep_diagonal=keep_diagonal, live_budget=live_budget, heads=heads,
        with_stats=telemetry,
    )
    out = _launch(
        "decode_gather_attention", dec_kernel.decode_gather_attention,
        q.reshape(bh, g, d).contiguous(),
        k_cache.reshape(bh, n_k, d), v_cache.reshape(bh, n_k, d),
        idx, val, cl_bh, key_block=bk, scale=scale,
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
    k_pool,
    v_pool,
    k_codes,
    k_scale,
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
    int32 ``[B, 4]`` stats summed over heads and query blocks. Under a
    tensor-parallel mesh, one :func:`_paged_prefill_core` per shard.
    """
    if len(round_bits) != 2:
        raise ValueError("fused prefill kernel supports 2-round configs")
    return _over_kv_shards(
        _paged_prefill_core, q, (k_pool, v_pool, k_codes, k_scale),
        (block_table, q_positions, diag_blocks), telemetry,
        round_bits=tuple(round_bits), alphas=tuple(alphas),
        query_block=query_block, key_block=key_block,
        block_budget=block_budget, keep_all=keep_all, keep_first=keep_first,
        keep_diagonal=keep_diagonal, scale=scale, with_stats=telemetry,
    )


def _paged_prefill_core(
    q, k_pool, v_pool, k_codes, k_scale, block_table, q_positions,
    diag_blocks, *, round_bits, alphas, query_block, key_block,
    block_budget, keep_all, keep_first, keep_diagonal, scale, with_stats,
):
    """Shard-local fused paged prefill: the pipeline of
    :func:`fused_paged_prefill_attention` over whatever KV-head slice of
    the pools it is given. Returns ``(out, stats_or_None)``."""
    batch, heads, n_q, d = q.shape
    bk = key_block
    num_pages = k_pool.shape[-2] // bk
    bh = batch * heads

    q16 = qlib.quantize_int16(q, axis=-1)
    # one slot's planes reshape to a strided view: the kernels take rows
    qp = q16.bit_plane(round_bits[-1]).reshape(bh, n_q, d).contiguous()
    qs = q16.scale.reshape(bh, n_q, 1)
    qpos_bh = q_positions.to(torch.int32).repeat_interleave(heads, dim=0)
    bt_bh = _head_offset_table(block_table, heads, num_pages)

    s0, s1 = _launch(
        "mpmrf_paged_prefill_filter_scores",
        pre_kernel.paged_prefill_filter_scores, qp, qs, qpos_bh,
        k_codes.reshape(heads * num_pages, bk, d),
        k_scale.reshape(heads * num_pages, 1),
        bt_bh, round_bits=round_bits, query_block=query_block,
        key_block=bk,
    )
    idx, val, stats = _fused_prefill_select(
        s0, s1, round_bits=round_bits, alphas=alphas,
        query_block=query_block, key_block=bk, block_budget=block_budget,
        keep_all=keep_all, keep_first=keep_first,
        keep_diagonal=keep_diagonal, diag_blocks=diag_blocks, heads=heads,
        with_stats=with_stats,
    )
    out = _launch(
        "paged_prefill_gather_attention",
        pre_kernel.paged_prefill_gather_attention, q.reshape(bh, n_q, d).contiguous(), qpos_bh,
        k_pool.reshape(heads * num_pages, bk, d),
        v_pool.reshape(heads * num_pages, bk, d),
        idx, val, bt_bh, query_block=query_block, key_block=bk, scale=scale,
    ).reshape(batch, heads, n_q, d)
    if with_stats:
        stats = stats.reshape(batch, heads, 4).sum(1, dtype=torch.int32)
    return out, stats


def fused_prefill_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_codes: torch.Tensor,
    k_block_scale: torch.Tensor,
    q_positions: torch.Tensor,
    *,
    round_bits: Tuple[int, ...] = (2, 4),
    alphas: Tuple[float, ...] = (0.0, 0.0),
    query_block: int = 128,
    key_block: int = 128,
    filter_block: int = 64,
    block_budget: int = 8,
    keep_all: bool = False,
    keep_first: bool = True,
    keep_diagonal: bool = True,
    diag_blocks: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    telemetry: bool = False,
):
    """Fused prefill over the contiguous cache (B7 → selection → B8).

    q ``[B, KV, n_q, d]`` folded chunk rows; k_cache/v_cache/k_codes
    ``[B, KV, n_k, d]``; k_block_scale f32 ``[B, KV, n_k // filter_block]``
    (the decode key block the cache quantizes at — a prefill key tile may
    span several, so B7 reads each row's scale, expanded here);
    q_positions int32 ``[B, n_q]`` (sentinels ≥ n_k); diag_blocks
    optional int32 ``[B, n_qb]``. Returns ``[B, KV, n_q, d]``; with
    ``telemetry`` also int32 ``[B, 4]`` stats summed over heads and
    query blocks.
    """
    if len(round_bits) != 2:
        raise ValueError("fused prefill kernel supports 2-round configs")
    batch, heads, n_q, d = q.shape
    n_k = k_cache.shape[-2]
    if n_k % filter_block:
        raise ValueError(
            f"cache rows {n_k} not divisible by filter block {filter_block}"
        )
    bh = batch * heads

    q16 = qlib.quantize_int16(q, axis=-1)
    # one slot's planes reshape to a strided view: the kernels take rows
    qp = q16.bit_plane(round_bits[-1]).reshape(bh, n_q, d).contiguous()
    qs = q16.scale.reshape(bh, n_q, 1)
    qpos_bh = q_positions.to(torch.int32).repeat_interleave(heads, dim=0)
    ks_row = torch.repeat_interleave(
        k_block_scale.float(), filter_block, dim=-1
    ).reshape(bh, n_k)

    s0, s1 = _launch(
        "mpmrf_prefill_filter_scores", pre_kernel.mpmrf_prefill_filter_scores,
        qp, qs, qpos_bh, k_codes.reshape(bh, n_k, d), ks_row,
        round_bits=tuple(round_bits), query_block=query_block,
        key_block=key_block,
    )
    idx, val, stats = _fused_prefill_select(
        s0, s1, round_bits=round_bits, alphas=alphas,
        query_block=query_block, key_block=key_block,
        block_budget=block_budget, keep_all=keep_all, keep_first=keep_first,
        keep_diagonal=keep_diagonal, diag_blocks=diag_blocks, heads=heads,
        with_stats=telemetry,
    )
    out = _launch(
        "prefill_gather_attention", pre_kernel.prefill_gather_attention,
        q.reshape(bh, n_q, d).contiguous(), qpos_bh,
        k_cache.reshape(bh, n_k, d), v_cache.reshape(bh, n_k, d),
        idx, val, query_block=query_block, key_block=key_block, scale=scale,
    ).reshape(batch, heads, n_q, d)
    if telemetry:
        return out, stats.reshape(batch, heads, 4).sum(1, dtype=torch.int32)
    return out

"""Memory-bounded (chunked) MP-MRF attention for long sequences (port of
``repro.core.chunked_attention``).

Past ``chunk_threshold`` the ``[n_q, n_k]`` score and mask tensors of
the direct paths no longer fit. These variants loop over query chunks
(the reference's ``lax.scan``) and build each chunk's mask from
positions, so peak memory is one chunk's ``chunk × n_k`` (or
``bq × B·bk``) scores. Numerics follow the reference: the same NEG_INF
conventions and f32 accumulation.

They are also the plain version the kernel route of
:func:`repro_torch.core.energon_attention.energon_attention`'s chunked
branch (B9 → selection → B10) is held against: B9 computes exactly
:func:`mpmrf_block_scores_chunked`'s block planes.

All functions take ``[B, H, n, d]`` operands.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import filtering as flt
from repro_torch.core import quantization as qlib

NEG_INF = -1e30


def _chunk_mask(
    n_k: int,
    chunk: int,
    start: int,
    *,
    causal: bool,
    window,
    q_offset: int,
    kv_length: Optional[torch.Tensor],
    device,
) -> torch.Tensor:
    """Validity of one query chunk: ``[B or 1, 1, chunk, n_k]``."""
    qpos = q_offset + start + torch.arange(chunk, device=device)[:, None]
    kpos = torch.arange(n_k, device=device)[None, :]
    if causal:
        mask = kpos <= qpos
        if window is not None and window > 0:
            mask = mask & (kpos > qpos - window)
    else:
        mask = torch.ones((chunk, n_k), dtype=torch.bool, device=device)
    mask = mask[None, None]
    if kv_length is not None:
        in_range = kpos < kv_length.to(device)[:, None]    # [B, n_k]
        mask = mask & in_range[:, None, None, :]
    return mask


def dense_attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window=None,
    q_offset: int = 0,
    kv_length: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    chunk: int = 512,
) -> torch.Tensor:
    """Dense attention a query chunk at a time (f32 throughout, output
    in ``v``'s dtype)."""
    b, h, n_q, d = q.shape
    n_k = k.shape[-2]
    chunk = min(chunk, n_q)
    while n_q % chunk:
        chunk //= 2
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kt = k.float().transpose(-1, -2)
    vf = v.float()
    outs = []
    for start in range(0, n_q, chunk):
        s = torch.matmul(q[:, :, start:start + chunk].float(), kt) * scale
        mask = _chunk_mask(n_k, chunk, start, causal=causal, window=window,
                           q_offset=q_offset, kv_length=kv_length,
                           device=q.device)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        outs.append(torch.matmul(p / l, vf))
    return torch.cat(outs, dim=2).to(v.dtype)


def mpmrf_block_scores_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    round_bits: Tuple[int, ...],
    *,
    query_block: int,
    key_block: int,
    causal: bool = True,
    window=None,
    q_offset: int = 0,
    kv_length: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both rounds' block-max score planes, a query block at a time.

    Per query block the int32 accumulators ``acc0 = q·msbᵀ`` and ``acc1 =
    (acc0 << (hi-lo)) + q·remᵀ`` are scaled by the q rows' scale, masked
    and pooled; the per-head k scale and the planes' powers of two are
    applied once at the end (the reference's deferred chain). Returns
    ``(s0, s1, blk_valid)``, each ``[B, H, n_qb, n_kb]``."""
    lo, hi = round_bits
    b, h, n_q, d = q.shape
    n_k = k.shape[-2]
    bq, bk = query_block, key_block
    n_kb = n_k // bk

    q16 = qlib.quantize_int16(q, axis=-1)
    k16 = qlib.quantize_int16(k, axis=(-2, -1))
    # int8 planes, as the reference (and B9) take them
    qp = q16.bit_plane(hi).to(torch.int8)
    k_msb = k16.bit_plane(lo).to(torch.int8)
    k_rem = k16.lsb_remainder(lo, hi).to(torch.int8)
    i8 = (128, 128)
    s0s, s1s, valids = [], [], []
    for start in range(0, n_q, bq):
        qi = qp[:, :, start:start + bq]
        qs = q16.scale[:, :, start:start + bq]
        acc0 = qlib.int_qk_matmul(qi, k_msb, i8)
        acc1 = (acc0 << (hi - lo)) + qlib.int_qk_matmul(qi, k_rem, i8)
        mask = _chunk_mask(n_k, bq, start, causal=causal, window=window,
                           q_offset=q_offset, kv_length=kv_length,
                           device=q.device)
        for acc, out in ((acc0, s0s), (acc1, s1s)):
            s = torch.where(mask, acc.float() * qs, NEG_INF)
            out.append(s.reshape(b, h, bq, n_kb, bk).amax(dim=(2, 4)))
        valids.append(mask.expand(b, h, bq, n_k).reshape(
            b, h, bq, n_kb, bk).any(dim=4).any(dim=2))
    s0, s1, valid = (torch.stack(x, dim=2) for x in (s0s, s1s, valids))
    k_scale = k16.scale.reshape(b, h, 1, 1)
    q_plane_factor = float(2 ** (16 - hi))
    s0 = torch.where(s0 <= NEG_INF / 2, NEG_INF,
                     s0 * k_scale * q_plane_factor * float(2 ** (16 - lo)))
    s1 = torch.where(s1 <= NEG_INF / 2, NEG_INF,
                     s1 * k_scale * q_plane_factor * float(2 ** (16 - hi)))
    return s0, s1, valid


def select_blocks_from_scores(
    s0_blk: torch.Tensor,
    s1_blk: torch.Tensor,
    blk_valid: torch.Tensor,
    *,
    alphas: Tuple[float, ...],
    block_budget: int,
    query_block: int,
    key_block: int,
    keep_first: bool = True,
    keep_diagonal: bool = True,
    keep_all: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two Eq. 3 rounds (none with ``keep_all``), the keep-first /
    diagonal pins and top-B on the block planes. Returns int32
    ``(block_indices, block_valid)`` ``[B, H, n_qb, B]``."""
    n_qb, n_kb = s0_blk.shape[-2:]
    keep = blk_valid
    if not keep_all:
        keep = keep & (s0_blk >= flt.eq3_threshold(s0_blk, alphas[0], keep))
        keep = keep & (s1_blk >= flt.eq3_threshold(s1_blk, alphas[1], keep))
    if keep_first:
        keep = keep.clone()
        keep[..., 0] = blk_valid[..., 0]
    if keep_diagonal:
        diag = torch.clamp(
            (torch.arange(n_qb, device=keep.device) * query_block)
            // key_block, max=n_kb - 1)
        keep = keep | (flt.one_hot_bool(diag, n_kb) & blk_valid)
    sel = torch.where(keep, s1_blk, NEG_INF)
    top_vals, idx = flt.top_k_stable(sel, min(block_budget, n_kb))
    valid01 = (top_vals > NEG_INF / 2).to(torch.int32)
    idx = torch.where(valid01 > 0, idx, 0).to(torch.int32)
    return idx, valid01


def block_gather_attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_indices: torch.Tensor,
    block_valid: torch.Tensor,
    *,
    query_block: int,
    key_block: int,
    causal: bool = True,
    window=None,
    q_offset: int = 0,
    kv_length: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The Attention Unit a query block at a time: each block gathers its
    B survivor key/value blocks and attends them under the validity,
    causal, window and ``kv_length`` masks (f32; output in ``v``'s
    dtype)."""
    b, h, n_q, d = q.shape
    n_k = k.shape[-2]
    bq, bk = query_block, key_block
    n_kb = n_k // bk
    budget = block_indices.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kb = k.reshape(b, h, n_kb, bk, d)
    vb = v.reshape(b, h, n_kb, bk, d)
    rows = torch.arange(b, device=q.device)[:, None, None]
    heads = torch.arange(h, device=q.device)[None, :, None]
    offs = torch.arange(bk, device=q.device)
    outs = []
    for i, start in enumerate(range(0, n_q, bq)):
        idx = block_indices[:, :, i].long()                 # [B, H, budget]
        val = block_valid[:, :, i]
        # The reference selects the blocks with a one-hot contraction
        # (on the TPU a gather's backward is a scatter-add that the SPMD
        # partitioner replicates). Each slot's one-hot row has a single
        # 1, so the contraction sums one nonzero term: it equals this
        # gather bit for bit.
        kg = kb[rows, heads, idx].float()                   # [B,H,budget,bk,d]
        vg = vb[rows, heads, idx].float()
        s = torch.einsum("bhqd,bhjkd->bhqjk",
                         q[:, :, start:start + bq].float(), kg) * scale
        qpos = (q_offset + start
                + torch.arange(bq, device=q.device))[:, None, None]
        kpos = idx[:, :, None, :, None] * bk + offs         # [B,H,1,budget,bk]
        mask = (val > 0)[:, :, None, :, None]
        if causal:
            mask = mask & (kpos <= qpos)
            if window is not None and window > 0:
                mask = mask & (kpos > qpos - window)
        if kv_length is not None:
            mask = mask & (kpos < kv_length.to(q.device)[:, None, None, None,
                                                          None])
        s = torch.where(mask, s, NEG_INF)
        flat = s.reshape(b, h, bq, budget * bk)
        m = flat.amax(dim=-1, keepdim=True)
        p = torch.where(flat <= NEG_INF / 2, 0.0, torch.exp(flat - m))
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        p = (p / l).reshape(s.shape)
        outs.append(torch.einsum("bhqjk,bhjkd->bhqd", p, vg))
    return torch.cat(outs, dim=2).to(v.dtype)


def energon_block_attention_chunked(
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
    window=None,
    q_offset: int = 0,
    kv_length: Optional[torch.Tensor] = None,
    keep_first: bool = True,
    keep_diagonal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The whole MP-MRF block pipeline, memory-bounded: filter → select →
    Attention Unit."""
    n_kb = k.shape[-2] // key_block
    budget = max(1, math.ceil(n_kb / pruning_ratio))
    s0, s1, valid = mpmrf_block_scores_chunked(
        q, k, round_bits, query_block=query_block, key_block=key_block,
        causal=causal, window=window, q_offset=q_offset, kv_length=kv_length,
    )
    idx, val01 = select_blocks_from_scores(
        s0, s1, valid, alphas=alphas, block_budget=budget,
        query_block=query_block, key_block=key_block, keep_first=keep_first,
        keep_diagonal=keep_diagonal, keep_all=pruning_ratio <= 1.0,
    )
    return block_gather_attention_chunked(
        q, k, v, idx, val01, query_block=query_block, key_block=key_block,
        causal=causal, window=window, q_offset=q_offset,
        kv_length=kv_length, scale=scale,
    )

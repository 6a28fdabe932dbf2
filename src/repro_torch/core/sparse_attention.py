"""The Attention Unit's torch paths (port of
``repro.core.sparse_attention``): dense attention (the unpruned prefix
layers and the baseline), masked sparse attention over a token keep
mask (the row path), and the block gathers of the reference's XLA
paths, full-sequence and decode, contiguous and paged.

As the reference does, these round the probabilities to ``v``'s dtype
before P·V. The fused kernels keep P at f32, so in bf16 the two differ
by more than the kernels' gather tolerance; their survivor tables are
what must agree bit for bit.

Last, the flash-style partial statistics and their log-sum-exp merge
(:func:`partial_attention_stats`, :func:`merge_partial_attention`):
attention split over shards of the keys, merged exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scaled-dot-product attention with f32 scores and softmax.

    q ``[..., n_q, d]``, k/v ``[..., n_k, d]``; ``valid`` a bool mask
    broadcastable to ``[..., n_q, n_k]``. Output in ``v``'s dtype.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def _masked_softmax(scores: torch.Tensor, dead: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis where ``dead`` pairs get probability
    exactly 0; a row with no live pair gives zeros, not NaNs."""
    row_max = scores.amax(dim=-1, keepdim=True)
    exp = torch.where(dead, 0.0, torch.exp(scores - row_max))
    return exp / torch.clamp(exp.sum(dim=-1, keepdim=True), min=1e-30)


def masked_sparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    keep_mask: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over exactly the pairs of the token-level ``keep_mask``
    (Alg. 2 lines 14-18), f32 scores and softmax."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = torch.where(keep_mask, scores, NEG_INF)
    probs = _masked_softmax(scores, ~keep_mask)
    return torch.matmul(probs.to(v.dtype), v)


def block_gather_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_indices: torch.Tensor,
    valid: Optional[torch.Tensor],
    query_block: int,
    key_block: int,
    scale: Optional[float] = None,
    block_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Each query block attends only its B gathered survivor key blocks.

    q ``[..., n_q, d]``, k/v ``[..., n_k, d]``; block_indices int
    ``[..., n_qb, B]``; ``valid`` bool broadcastable to ``[..., n_q,
    n_k]``, re-applied inside the gathered tiles; ``block_valid`` 0 for
    padded slots, which never attend."""
    *lead, n_q, d = q.shape
    n_k = k.shape[-2]
    bq, bk = query_block, key_block
    n_qb, n_kb = n_q // bq, n_k // bk
    budget = block_indices.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    idx = block_indices.long()

    qb = q.reshape(*lead, n_qb, bq, d)
    kb = k.reshape(*lead, 1, n_kb, bk, d)
    vb = v.reshape(*lead, 1, n_kb, bk, d)
    at = idx[..., None, None].expand(*idx.shape, bk, d)
    kg = torch.take_along_dim(kb, at, dim=-3)            # [..., n_qb, B, bk, d]
    vg = torch.take_along_dim(vb, at, dim=-3)

    scores = torch.einsum("...iqd,...ibkd->...iqbk", qb.float(),
                          kg.float()) * scale
    dead = None
    if valid is not None:
        vt = valid.expand(*lead, n_q, n_k).reshape(
            *lead, n_qb, bq, n_kb, bk).transpose(-3, -2)  # [.., n_qb, n_kb, bq, bk]
        mi = idx[..., None, None].expand(*idx.shape, bq, bk)
        vg_mask = torch.take_along_dim(vt, mi, dim=-3).transpose(-3, -2)
        dead = ~vg_mask
    if block_valid is not None:
        pad = (block_valid <= 0)[..., :, None, :, None]
        dead = pad if dead is None else dead | pad
    if dead is not None:
        scores = torch.where(dead, NEG_INF, scores)
    flat = scores.reshape(*scores.shape[:-2], budget * bk)
    probs = _masked_softmax(flat, flat <= NEG_INF / 2).reshape(scores.shape)
    out = torch.einsum("...iqbk,...ibkd->...iqd", probs.to(v.dtype), vg)
    return out.reshape(*lead, n_q, d)


def decode_sparse_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    keep_mask: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token sparse attention over a cache under a token keep mask
    (which already holds the cache-length validity)."""
    return masked_sparse_attention(q, k_cache, v_cache, keep_mask, scale)


def decode_block_gather_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_indices: torch.Tensor,
    block_valid: torch.Tensor,
    cache_length: torch.Tensor,
    key_block: int,
    *,
    window=None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over the B survivor key blocks of a padded cache:
    q ``[..., n_q, d]`` (the folded group rows), caches ``[..., n_k, d]``,
    block_indices / block_valid ``[..., 1, B]`` (shared by the rows)."""
    *lead, _, d = q.shape
    n_k = k_cache.shape[-2]
    bk = key_block
    idx = block_indices[..., 0, :].long()                 # [..., B]
    at = idx[..., None, None].expand(*idx.shape, bk, d)
    kg = torch.take_along_dim(k_cache.reshape(*lead, n_k // bk, bk, d), at,
                              dim=-3)
    vg = torch.take_along_dim(v_cache.reshape(*lead, n_k // bk, bk, d), at,
                              dim=-3)
    return _gathered_decode_attention(
        q, kg, vg, idx, block_valid, cache_length, bk, window=window,
        scale=scale)


def paged_decode_block_gather_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_indices: torch.Tensor,
    block_valid: torch.Tensor,
    block_table: torch.Tensor,
    cache_length: torch.Tensor,
    key_block: int,
    *,
    window=None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`decode_block_gather_attention` out of the shared pool: the
    logical survivor table composed with the block table names the
    physical pages, and only those are gathered (the same tiles, so the
    same bits, as the unpaged path). q ``[B, KV, n_q, d]``; pools
    ``[KV, pool_rows, d]`` (or their head shards)."""
    from repro_torch.runtime import paged_cache as pgc

    bk = key_block
    idx = block_indices[..., 0, :]                        # [B, KV, budget]
    phys = pgc.compose_physical_blocks(block_table, idx)
    kg = pgc.gather_pages(k_pool, phys, bk)
    vg = pgc.gather_pages(v_pool, phys, bk)
    return _gathered_decode_attention(
        q, kg, vg, idx.long(), block_valid, cache_length, bk, window=window,
        scale=scale)


def _gathered_decode_attention(
    q: torch.Tensor,
    kg: torch.Tensor,
    vg: torch.Tensor,
    idx: torch.Tensor,
    block_valid: torch.Tensor,
    cache_length: torch.Tensor,
    bk: int,
    *,
    window=None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Shared tail of the block-gather decode paths: q ``[..., n_q, d]``;
    kg/vg ``[..., B, bk, d]``; ``idx`` ``[..., B]`` logical block ids
    (they place the key positions); block_valid ``[..., 1, B]``."""
    d = q.shape[-1]
    budget = idx.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.einsum("...qd,...jkd->...qjk", q.float(),
                          kg.float()) * scale             # [..., n_q, B, bk]
    # budget-padding slots alias block 0: masking them also keeps the
    # keep-everything budget exactly dense despite the duplicates
    kpos = idx[..., None, :, None] * bk + torch.arange(bk, device=q.device)
    cl = cache_length.reshape((cache_length.shape[0],)
                              + (1,) * (kpos.dim() - 1))
    mask = (kpos < cl) & (block_valid[..., 0, :][..., None, :, None] > 0)
    if window is not None and window > 0:
        mask = mask & (kpos >= cl - window)
    scores = torch.where(mask, scores, NEG_INF)
    flat = scores.reshape(*scores.shape[:-2], budget * bk)
    probs = _masked_softmax(flat, flat <= NEG_INF / 2).reshape(scores.shape)
    return torch.einsum("...qjk,...jkd->...qd", probs.to(vg.dtype), vg)


def merge_partial_attention(
    outs: torch.Tensor,
    maxes: torch.Tensor,
    sums: torch.Tensor,
    axis: int = 0,
) -> torch.Tensor:
    """Log-sum-exp merge of flash-style partial attention results: every
    shard computed (unnormalized out, running max, running denominator)
    over its own keys; the merge is exact up to rounding. outs ``[S, …,
    n_q, d]``, maxes / sums ``[S, …, n_q, 1]`` with the S shards on
    ``axis``."""
    g_max = maxes.amax(dim=axis, keepdim=True)
    corr = torch.exp(maxes - g_max)
    num = (outs * corr).sum(dim=axis)
    den = (sums * corr).sum(dim=axis)
    return num / torch.clamp(den, min=1e-30)


def partial_attention_stats(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    keep_mask: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shard's flash statistics for :func:`merge_partial_attention`:
    ``(exp(s − m)·V, m, Σ exp(s − m))`` over the keys ``keep_mask``
    admits, scores in f32 (the max is NEG_INF on a row with none)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = torch.where(keep_mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    exp = torch.where(keep_mask, torch.exp(scores - m), 0.0)
    s = exp.sum(dim=-1, keepdim=True)
    out = torch.matmul(exp.to(v.dtype), v)
    return out, m, s

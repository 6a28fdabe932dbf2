"""GQA attention (port of ``repro.models.attention``): the
full-sequence block and the serving blocks over the paged KV cache and
over the contiguous (unpaged) one.

Activations stay ``[batch, seq, d_model]``. The full-sequence block
repeats each KV head to its G = H/KV query heads, as the reference
does, and hands ``[B, H, n, hd]`` to :func:`energon_attention`. The
serving blocks fold the G query heads of each KV head into the query
axis, ``[B, KV, G·C, hd]`` (group-major), so the attention kernels see
one KV head per row.

The port updates both caches **in place** (the reference returns new
caches functionally): a chunk's K/V rows are written with
``index_put_`` — through the block table into the pool, or at their
positions into the contiguous ``[B, KV, max_len, hd]`` cache, where the
reference scatters with a one-hot product — and the filter planes are
refreshed in the same leaves. Positions past the cache (padding
sentinels) write nothing in either layout. The cache is the one
resident copy, so nothing is duplicated per step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import (
    EnergonConfig,
    energon_attention,
    energon_decode_attention,
    energon_paged_decode_attention,
    energon_paged_prefill_attention,
)
from repro_torch.core import quantization as qlib
from repro_torch.models import layers as L
from repro_torch.runtime import paged_cache as pgc


def init_attention(
    generator: torch.Generator, device, d_model: int, num_heads: int,
    num_kv_heads: int, head_dim: int, use_qk_norm: bool = False,
    dtype=torch.float32,
) -> Dict[str, object]:
    """Attention weights with the reference's layouts and stds:
    wq ``[d, H, hd]``, wk/wv ``[d, KV, hd]``, wo ``[H, hd, d]``."""
    std = d_model ** -0.5
    tn = lambda shape, s: L.trunc_normal(shape, s, generator, device, dtype)
    params = {
        "wq": tn((d_model, num_heads, head_dim), std),
        "wk": tn((d_model, num_kv_heads, head_dim), std),
        "wv": tn((d_model, num_kv_heads, head_dim), std),
        "wo": tn((num_heads, head_dim, d_model),
                 (num_heads * head_dim) ** -0.5),
    }
    if use_qk_norm:
        params["q_norm"] = {"scale": torch.ones(head_dim, dtype=dtype,
                                                device=device)}
        params["k_norm"] = {"scale": torch.ones(head_dim, dtype=dtype,
                                                device=device)}
    return params


def _project_qkv(
    params, x: torch.Tensor, positions: torch.Tensor,
    use_qk_norm: bool, rope_theta: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x ``[B, n, d_model]`` → q ``[B, n, H, hd]``, k/v ``[B, n, KV, hd]``."""
    def proj(w):
        d, h, hd = w.shape
        return (x @ w.reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    if use_qk_norm:
        q = L.rmsnorm(params["q_norm"], q)
        k = L.rmsnorm(params["k_norm"], k)
    q = L.apply_rope(q, positions, rope_theta)
    k = L.apply_rope(k, positions, rope_theta)
    return q, k, v


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """``[B, KV, n, hd]`` → ``[B, KV·groups, n, hd]`` (each KV head
    repeated for its query heads, in order)."""
    if groups == 1:
        return x
    return torch.repeat_interleave(x, groups, dim=1)


def attention_block(
    params,
    x: torch.Tensor,
    energon: EnergonConfig,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float = 10000.0,
    use_qk_norm: bool = False,
    window: Optional[int] = None,
    layer_index: int = 10**9,
) -> torch.Tensor:
    """Full-sequence causal attention at positions 0 .. n−1.
    x ``[B, n, d]`` → ``[B, n, d]``."""
    batch, n, _ = x.shape
    positions = torch.arange(n, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, positions, use_qk_norm, rope_theta)
    groups = num_heads // num_kv_heads
    out = energon_attention(
        q.transpose(1, 2),                              # [B, H, n, hd]
        _repeat_kv(k.transpose(1, 2), groups),
        _repeat_kv(v.transpose(1, 2), groups),
        energon, causal=True, window=window, layer_index=layer_index,
    )
    wo = params["wo"]
    out = out.transpose(1, 2).reshape(batch, n, -1)     # [B, n, H·hd]
    return out @ wo.reshape(-1, wo.shape[-1])


def init_kv_cache(
    batch: int, num_kv_heads: int, max_len: int, head_dim: int, dtype,
    device, filter_block: int = 0,
) -> Dict[str, torch.Tensor]:
    """One layer's contiguous decode cache ``[B, KV, max_len, hd]``;
    ``filter_block > 0`` adds the resident filter planes: int16 codes in
    the same layout and one f32 absmax scale per ``filter_block``-row
    key block, kept fresh by the writers."""
    shape = (batch, num_kv_heads, max_len, head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
    if filter_block > 0:
        if max_len % filter_block:
            raise ValueError(
                f"max_len {max_len} not divisible by filter block "
                f"{filter_block}"
            )
        cache["k_codes"] = torch.zeros(shape, dtype=torch.int16,
                                       device=device)
        cache["k_scale"] = torch.zeros(
            (batch, num_kv_heads, max_len // filter_block),
            dtype=torch.float32, device=device,
        )
    return cache


@dataclasses.dataclass(frozen=True)
class CacheWrite:
    """Where one call's K/V rows land in the contiguous cache: ``src``
    indexes the written tokens of the flattened ``[B·C]`` chunk,
    ``slot`` / ``pos`` their batch row and cache row. Computed once per
    call (:func:`cache_write_plan`), as :class:`PagedWrite` is."""

    src: torch.Tensor
    slot: torch.Tensor
    pos: torch.Tensor


def cache_write_plan(positions: torch.Tensor, max_len: int) -> CacheWrite:
    """Token (b, c) lands in row ``positions[b, c]`` of slot b; positions
    outside ``[0, max_len)`` — the padding and idle-slot sentinels —
    write nothing, as the reference's all-zero one-hot rows do."""
    pos = positions.reshape(-1).long()
    src = torch.nonzero((pos >= 0) & (pos < max_len)).reshape(-1)
    return CacheWrite(src=src, slot=src // positions.shape[1], pos=pos[src])


def _refresh_filter_block(
    cache: Dict[str, torch.Tensor], pos: torch.Tensor, block: int
) -> None:
    """Re-quantize, in place, the key block each slot's append at
    ``pos [B]`` touched: after every write, block j's codes and scale
    equal a fresh per-block quantization of its rows. As the reference
    does, a position past the cache (an idle slot's sentinel) clips to
    the last block, which re-quantizes unchanged rows."""
    k = cache["k"]
    batch, kv, max_len, hd = k.shape
    n_kb = max_len // block
    rows = torch.arange(batch, device=k.device)
    blk = torch.clamp(pos.long(), 0, max_len - 1) // block
    sel = k.view(batch, kv, n_kb, block, hd)[rows, :, blk]   # [B,KV,bk,hd]
    codes, scale = qlib.quantize_int16_blocks(sel, block)
    cache["k_codes"].view(batch, kv, n_kb, block, hd)[rows, :, blk] = codes
    cache["k_scale"][rows, :, blk] = scale[..., 0]


def _fold_groups(q: torch.Tensor, num_heads: int,
                 num_kv_heads: int) -> torch.Tensor:
    """``[B, C, H, hd]`` queries → ``[B, KV, G·C, hd]`` (group-major)."""
    batch, chunk, _, hd = q.shape
    groups = num_heads // num_kv_heads
    return q.transpose(1, 2).reshape(batch, num_kv_heads, groups * chunk, hd)


def _project_update_fold(
    params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    positions: torch.Tensor,
    write: CacheWrite,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float,
    use_qk_norm: bool,
    filter_block: int,
) -> torch.Tensor:
    """Project the chunk, write its K/V rows into the contiguous cache
    where ``write`` says (in place) and fold GQA groups into the query
    axis.

    The filter planes are refreshed at the write: a decode append
    (C = 1) re-quantizes the one block each slot's position falls in; a
    prefill chunk re-quantizes every block of the cache. Returns
    ``q_folded [B, KV, G·C, hd]``.
    """
    chunk = x.shape[1]
    q, k, v = _project_qkv(params, x, positions, use_qk_norm, rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    hd = k.shape[-1]
    k_cache[write.slot, :, write.pos] = (
        k.reshape(-1, num_kv_heads, hd)[write.src].to(k_cache.dtype))
    v_cache[write.slot, :, write.pos] = (
        v.reshape(-1, num_kv_heads, hd)[write.src].to(v_cache.dtype))
    if "k_codes" in cache:
        if filter_block <= 0:
            raise ValueError(
                "cache carries filter planes but filter_block is unset")
        if chunk == 1:
            _refresh_filter_block(cache, positions[:, 0], filter_block)
        else:
            codes, scales = qlib.quantize_int16_blocks(k_cache, filter_block)
            cache["k_codes"].copy_(codes)
            cache["k_scale"].copy_(scales)
    return _fold_groups(q, num_heads, num_kv_heads)


def prefill_attention_block(
    params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    positions: torch.Tensor,
    write: CacheWrite,
    energon: EnergonConfig,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float = 10000.0,
    use_qk_norm: bool = False,
    window: Optional[int] = None,
    layer_index: int = 10**9,
) -> torch.Tensor:
    """Chunked-prefill attention against the contiguous cache. x
    ``[B, C, d]``; positions ``[B, C]`` (sentinels ≥ max_len write
    nothing and produce outputs the caller ignores); ``write`` from
    :func:`cache_write_plan`. The chunk attends the updated cache under
    a per-row causal mask, reading the planes refreshed by its own
    write. Returns ``[B, C, d]``."""
    chunk = x.shape[1]
    qg = _project_update_fold(
        params, x, cache, positions, write,
        num_heads=num_heads, num_kv_heads=num_kv_heads,
        rope_theta=rope_theta, use_qk_norm=use_qk_norm,
        filter_block=energon.decode_key_block,
    )
    groups = num_heads // num_kv_heads
    qpos = positions.repeat(1, groups)       # folded row (g, c) → pos[c]
    out = energon_attention(
        qg, cache["k"], cache["v"], energon,
        causal=True, window=window, layer_index=layer_index,
        q_positions=qpos, filter_cache=_filter_planes(cache),
    )
    return _unfold_heads_out(out, params, num_heads, chunk)


def decode_attention_block(
    params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    cache_index: torch.Tensor,
    write: CacheWrite,
    energon: EnergonConfig,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float = 10000.0,
    use_qk_norm: bool = False,
    window: Optional[int] = None,
    layer_index: int = 10**9,
) -> torch.Tensor:
    """One-token decode step over the contiguous cache. x ``[B, 1, d]``;
    cache_index ``[B]`` (an idle slot's ``max_len`` sentinel writes
    nothing and attends every row); ``write`` from
    :func:`cache_write_plan`. Returns ``[B, 1, d]``."""
    qg = _project_update_fold(
        params, x, cache, cache_index[:, None], write,
        num_heads=num_heads, num_kv_heads=num_kv_heads,
        rope_theta=rope_theta, use_qk_norm=use_qk_norm,
        filter_block=energon.decode_key_block,
    )
    out = energon_decode_attention(
        qg, cache["k"], cache["v"], cache_index + 1, energon,
        layer_index=layer_index, window=window,
        filter_cache=_filter_planes(cache),
    )
    return _unfold_heads_out(out, params, num_heads, 1)


def _filter_planes(cache) -> Optional[Dict[str, torch.Tensor]]:
    if "k_codes" not in cache:
        return None
    return {"codes": cache["k_codes"], "scale": cache["k_scale"]}


def init_paged_kv_cache(
    num_pages: int, num_kv_heads: int, page_size: int, head_dim: int,
    dtype, device, filter_planes: bool = True,
) -> Dict[str, torch.Tensor]:
    """One layer's shared page pool: K/V rows ``[KV, pages·ps, hd]``
    plus, with ``filter_planes``, int16 codes in the same layout and one
    f32 absmax scale per physical page."""
    rows = num_pages * page_size
    cache = {
        "k": torch.zeros((num_kv_heads, rows, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((num_kv_heads, rows, head_dim), dtype=dtype,
                         device=device),
    }
    if filter_planes:
        cache["k_codes"] = torch.zeros((num_kv_heads, rows, head_dim),
                                       dtype=torch.int16, device=device)
        cache["k_scale"] = torch.zeros((num_kv_heads, num_pages),
                                       dtype=torch.float32, device=device)
    return cache


@dataclasses.dataclass(frozen=True)
class PagedWrite:
    """Where one call's K/V rows land in the pool: ``src`` indexes the
    written tokens of the flattened ``[B·C]`` chunk, ``rows`` their pool
    rows. The plan is the same for every layer, and finding the kept
    tokens syncs with the host, so the model computes it once per call
    (:func:`paged_write_plan`) instead of once per layer."""

    src: torch.Tensor
    rows: torch.Tensor


def paged_write_plan(
    positions: torch.Tensor,
    block_table: torch.Tensor,
    page_size: int,
    pool_rows: int,
    write_mask: Optional[torch.Tensor] = None,
) -> PagedWrite:
    """Token (b, c) at logical position p lands in pool row
    ``table[b, p // ps]·ps + p % ps``. Sentinel positions and masked-off
    slots resolve to :data:`~repro_torch.runtime.paged_cache.DROP_ROW`
    and are dropped *explicitly* — ``index_put_`` has no drop mode, and
    an idle slot's table may alias pages a live slot owns."""
    rowid = pgc.paged_row_targets(
        positions, block_table, page_size, write_mask=write_mask
    ).reshape(-1)
    src = torch.nonzero(rowid < pool_rows).reshape(-1)
    return PagedWrite(src=src, rows=rowid[src])


def _project_update_fold_paged(
    params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    positions: torch.Tensor,
    write: PagedWrite,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float,
    use_qk_norm: bool,
    filter_block: int,
) -> torch.Tensor:
    """Project the chunk, write its K/V rows into the pool where
    ``write`` says (in place) and fold GQA groups into the query axis.

    The filter planes are refreshed at the write: a decode append
    (C = 1) re-quantizes exactly the one page each writing slot touched;
    a prefill chunk re-quantizes the whole pool. Returns
    ``q_folded [B, KV, G·C, hd]``.
    """
    chunk = x.shape[1]
    ps = filter_block
    if ps <= 0:
        raise ValueError("paged cache needs a positive page size")
    q, k, v = _project_qkv(params, x, positions, use_qk_norm, rope_theta)
    k_pool, v_pool = cache["k"], cache["v"]
    # [B, C, KV, hd] → [KV, written, hd]
    k_rows = k.reshape(-1, num_kv_heads, k.shape[-1])[write.src].transpose(0, 1)
    v_rows = v.reshape(-1, num_kv_heads, v.shape[-1])[write.src].transpose(0, 1)
    k_pool[:, write.rows] = k_rows.to(k_pool.dtype)
    v_pool[:, write.rows] = v_rows.to(v_pool.dtype)

    if "k_codes" in cache:
        num_pages = cache["k_scale"].shape[-1]
        hd = k_pool.shape[-1]
        if chunk == 1:
            page = write.rows // ps          # one page per writing slot
            sel = k_pool.view(num_kv_heads, num_pages, ps, hd)[:, page]
            new_codes, new_scale = qlib.quantize_int16_blocks(sel, ps)
            cache["k_codes"].view(num_kv_heads, num_pages, ps, hd)[:, page] = (
                new_codes
            )
            cache["k_scale"][:, page] = new_scale[..., 0]
        else:
            codes, scales = qlib.quantize_int16_blocks(k_pool, ps)
            cache["k_codes"].copy_(codes)
            cache["k_scale"].copy_(scales)

    return _fold_groups(q, num_heads, num_kv_heads)


def _unfold_heads_out(
    out: torch.Tensor, params, num_heads: int, chunk: int
) -> torch.Tensor:
    """``[B, KV, G·C, hd]`` attention output → ``[B, C, d_model]``."""
    batch, _, _, head_dim = out.shape
    out = out.reshape(batch, num_heads, chunk, head_dim).transpose(1, 2)
    wo = params["wo"]
    return out.reshape(batch, chunk, -1) @ wo.reshape(-1, wo.shape[-1])


def paged_prefill_attention_block(
    params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    positions: torch.Tensor,
    block_table: torch.Tensor,
    write: PagedWrite,
    energon: EnergonConfig,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float = 10000.0,
    use_qk_norm: bool = False,
    window: Optional[int] = None,
    layer_index: int = 10**9,
) -> torch.Tensor:
    """Chunked-prefill attention against the page pool. x ``[B, C, d]``;
    positions ``[B, C]`` (sentinels ≥ logical rows write nothing and
    produce outputs the caller ignores); ``write`` from
    :func:`paged_write_plan`. Returns ``[B, C, d]``."""
    chunk = x.shape[1]
    qg = _project_update_fold_paged(
        params, x, cache, positions, write,
        num_heads=num_heads, num_kv_heads=num_kv_heads,
        rope_theta=rope_theta, use_qk_norm=use_qk_norm,
        filter_block=energon.decode_key_block,
    )
    groups = num_heads // num_kv_heads
    qpos = positions.repeat(1, groups)       # folded row (g, c) → pos[c]
    out = energon_paged_prefill_attention(
        qg, cache, block_table, qpos, energon,
        layer_index=layer_index, window=window,
    )
    return _unfold_heads_out(out, params, num_heads, chunk)


def paged_decode_attention_block(
    params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    cache_index: torch.Tensor,
    block_table: torch.Tensor,
    write: PagedWrite,
    energon: EnergonConfig,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float = 10000.0,
    use_qk_norm: bool = False,
    window: Optional[int] = None,
    layer_index: int = 10**9,
) -> torch.Tensor:
    """One-token paged decode step. x ``[B, 1, d]``; cache_index ``[B]``;
    ``write`` (from :func:`paged_write_plan` with the ``active`` slots'
    mask) says which slots' appends land. Returns ``[B, 1, d]``."""
    qg = _project_update_fold_paged(
        params, x, cache, cache_index[:, None], write,
        num_heads=num_heads, num_kv_heads=num_kv_heads,
        rope_theta=rope_theta, use_qk_norm=use_qk_norm,
        filter_block=energon.decode_key_block,
    )
    out = energon_paged_decode_attention(
        qg, cache, block_table, cache_index + 1, energon,
        layer_index=layer_index, window=window,
    )
    return _unfold_heads_out(out, params, num_heads, 1)

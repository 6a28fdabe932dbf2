"""Energon attention dispatch (port of ``repro.core.energon_attention``).

Ported: the serving entry points over both cache layouts — paged
(:func:`energon_paged_prefill_attention`,
:func:`energon_paged_decode_attention`) and contiguous
(:func:`energon_attention` at ``q_positions`` with resident planes,
:func:`energon_decode_attention`) — whose fused branches run the
hand-written CUDA kernels through :mod:`repro_torch.kernels.ops`, and
whose dense branches serve the prefix layers; and
:func:`energon_attention`'s full-sequence call (dense prefix layers,
``impl="pallas"`` through B9 + B10). A config that would reach the
reference's ``mpmrf_row`` / ``mpmrf_block`` XLA paths or the chunked
path raises ``NotImplementedError``; those wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import filtering as flt
from repro_torch.core import sparse_attention as spa

# Resident filter planes are allocated only for caches at least this long
# (the reference's measured crossover, kept so one config drives both).
FILTER_CACHE_AUTO_MIN_LEN = 1024


@dataclasses.dataclass(frozen=True)
class EnergonConfig:
    """Attention implementation selector + MP-MRF parameters (the same
    fields and defaults as the reference)."""

    impl: str = "mpmrf_block"  # dense | mpmrf_row | mpmrf_block | pallas
    round_bits: Tuple[int, ...] = (2, 4)
    alphas: Tuple[float, ...] = (0.0, 0.0)
    query_block: int = 128
    key_block: int = 128
    pruning_ratio: float = 4.0
    decode_key_block: int = 64
    filter_cache: bool = True
    filter_cache_min_len: Optional[int] = None
    keep_first: bool = True
    keep_diagonal: bool = True
    reuse_partial: bool = True
    min_prune_layer: int = 2
    chunk_threshold: int = 2048 * 2048

    @property
    def uses_decode_block(self) -> bool:
        return self.impl in ("mpmrf_block", "pallas") and \
            self.decode_key_block > 0

    @property
    def uses_filter_cache(self) -> bool:
        return self.filter_cache and self.uses_decode_block

    def filter_cache_engages(self, max_len: int) -> bool:
        """Do resident planes pay off at ``max_len`` cache rows?"""
        if not self.uses_filter_cache:
            return False
        threshold = self.filter_cache_min_len
        if threshold is None:
            threshold = FILTER_CACHE_AUTO_MIN_LEN
        return max_len >= threshold


def _zero_stats(batch: int, device) -> torch.Tensor:
    return torch.zeros((batch, 4), dtype=torch.int32, device=device)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} waits for a later slice of the PyTorch port; the "
        "port runs impl='pallas' through its kernels and the dense "
        "prefix layers"
    )


def energon_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: EnergonConfig,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    layer_index: int = 10**9,
    q_offset: int = 0,
    q_positions: Optional[torch.Tensor] = None,
    kv_length: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    filter_cache: Optional[Dict[str, torch.Tensor]] = None,
    telemetry: bool = False,
):
    """Multi-head attention ``[B, H, n, d]`` with Energon sparsity.

    Two calls are ported. The full-sequence call (``q_positions`` None;
    query row i at absolute position ``q_offset + i``): layers below
    ``cfg.min_prune_layer`` and ``impl="dense"`` take dense attention
    under the causal mask, and ``impl="pallas"`` runs the Filtering Unit
    (B9 + Eq. 3 + top-B) and the Attention Unit (B10) over
    ``[B·H, n, d]``. The chunked-prefill call (``q_positions`` int32
    ``[B, n_q]``, padding sentinels ≥ n_k wholly masked): with
    ``impl="pallas"`` and the cache's resident planes in
    ``filter_cache`` (``{"codes": int16 [B, H, n_k, d], "scale": f32
    [B, H, n_k // cfg.decode_key_block]}``) it runs the fused prefill
    kernels (B7 → selection → B8) before any ``[n_q, n_k]`` mask is
    built; the unpruned prefix layers take the dense branch.

    Every other branch of the reference raises up front with the reason
    (:func:`full_sequence_faults`): the row-granular fallback for
    sequences not divisible into two or more blocks, the chunked
    (flash-style) path past ``chunk_threshold``, the XLA block fallback
    for windows and padded caches, and the ``mpmrf_row`` /
    ``mpmrf_block`` impls. Telemetry reports zeros on these paths, as
    the reference's pure-kernel path does.
    """
    n_q, n_k = q.shape[-2], k.shape[-2]
    impl = "dense" if layer_index < cfg.min_prune_layer else cfg.impl
    if q_positions is not None:
        if (
            impl == "pallas" and causal and kv_length is None
            and n_q % cfg.query_block == 0 and n_k % cfg.key_block == 0
            and n_k // cfg.key_block > 1
            and _fused_prefill_engaged(cfg, filter_cache is not None,
                                       window, n_k)
        ):
            from repro_torch.kernels import ops as kops

            n_kb = n_k // cfg.key_block
            return kops.fused_prefill_attention(
                q, k, v, filter_cache["codes"], filter_cache["scale"],
                q_positions,
                round_bits=cfg.round_bits,
                alphas=cfg.alphas,
                query_block=cfg.query_block,
                key_block=cfg.key_block,
                filter_block=cfg.decode_key_block,
                block_budget=max(1, math.ceil(n_kb / cfg.pruning_ratio)),
                keep_all=cfg.pruning_ratio <= 1.0,
                keep_first=cfg.keep_first,
                keep_diagonal=cfg.keep_diagonal,
                diag_blocks=_prefill_diag_blocks(
                    q_positions, cfg.query_block, cfg.key_block, n_k
                ),
                scale=scale,
                telemetry=telemetry,
            )
        out = _positions_dense(q, k, v, cfg, impl, q_positions, causal,
                               window, scale)
    else:
        faults = full_sequence_faults(cfg, impl, n_q, n_k, window=window,
                                      kv_length=kv_length)
        if faults:
            raise _not_ported(
                f"this full-sequence call ({'; '.join(faults)})")
        if impl == "dense":
            valid = None
            if causal:
                valid = flt.causal_valid_mask(n_q, n_k, q_offset, q.device)
            out = spa.dense_attention(q, k, v, valid, scale)
        else:
            out = _pallas_attention(q, k, v, cfg, causal, q_offset, scale)
    if telemetry:
        return out, _zero_stats(q.shape[0], q.device)
    return out


def full_sequence_faults(
    cfg: EnergonConfig, impl: str, n_q: int, n_k: int, *,
    window: Optional[int] = None, kv_length=None,
) -> List[str]:
    """Why a full-sequence call with the effective ``impl`` would leave
    the ported branches (dense, or the B9 + B10 kernels). Empty when it
    can run."""
    faults = []
    fallback = ("the reference's XLA block fallback" if impl == "pallas"
                else "a mask of the dense path not ported yet")
    if kv_length is not None:
        faults.append(f"kv_length (padded caches) takes {fallback}")
    if window is not None:
        faults.append(f"window={window} takes {fallback}")
    if n_q * n_k > cfg.chunk_threshold:
        faults.append(
            f"n_q·n_k = {n_q}·{n_k} is past chunk_threshold="
            f"{cfg.chunk_threshold}: the chunked (flash-style) path "
            "(core/chunked_attention.py)")
    if impl in ("mpmrf_row", "mpmrf_block"):
        faults.append(f"impl={impl!r} (the XLA selection paths)")
    elif impl == "pallas":
        if n_q % cfg.query_block or n_k % cfg.key_block:
            faults.append(
                f"sequence {n_q}×{n_k} not divisible into "
                f"{cfg.query_block}×{cfg.key_block} blocks: the reference "
                "falls back to mpmrf_row")
        elif n_k // cfg.key_block <= 1:
            faults.append(
                f"one key block only ({n_k} keys of {cfg.key_block}): the "
                "reference falls back to mpmrf_row")
    elif impl != "dense":
        raise ValueError(f"unknown Energon impl: {impl}")
    return faults


def _positions_dense(q, k, v, cfg, impl, q_positions, causal, window, scale):
    """Dense attention at per-row positions (the paged prefix layers)."""
    n_q, n_k = q.shape[-2], k.shape[-2]
    if impl != "dense":
        raise _not_ported(f"energon_attention impl={impl!r} at q_positions")
    if n_q * n_k > cfg.chunk_threshold:
        raise ValueError(
            f"q_positions attention materializes [{n_q}, {n_k}] masks "
            f"past chunk_threshold={cfg.chunk_threshold}; lower the "
            "prefill chunk (or raise chunk_threshold)"
        )
    qpos = q_positions[:, None, :, None]
    kpos = torch.arange(n_k, device=q.device)[None, None, None, :]
    valid = qpos < n_k
    if causal:
        valid = valid & (kpos <= qpos)
    if window is not None and window > 0:
        valid = valid & (kpos > qpos - window)
    return spa.dense_attention(q, k, v, valid, scale)


def _pallas_attention(q, k, v, cfg, causal, q_offset, scale):
    """The Filtering Unit then the Attention Unit over ``[B·H, n, d]``."""
    from repro_torch.kernels import ops as kops

    batch, heads, n_q, d = q.shape
    n_k = k.shape[-2]
    budget = max(1, math.ceil((n_k // cfg.key_block) / cfg.pruning_ratio))
    qf = q.reshape(batch * heads, n_q, d)
    kf = k.reshape(batch * heads, n_k, d)
    vf = v.reshape(batch * heads, n_k, d)
    idx, val = kops.mpmrf_select_blocks(
        qf, kf,
        round_bits=cfg.round_bits,
        alphas=cfg.alphas,
        block_budget=budget,
        query_block=cfg.query_block,
        key_block=cfg.key_block,
        causal=causal,
        q_offset=q_offset,
        keep_first=cfg.keep_first,
        keep_diagonal=cfg.keep_diagonal,
    )
    out = kops.block_sparse_attention(
        qf, kf, vf, idx, val,
        query_block=cfg.query_block,
        key_block=cfg.key_block,
        causal=causal,
        q_offset=q_offset,
        scale=scale,
    )
    return out.reshape(q.shape)


def decode_live_budget(
    cache_length: torch.Tensor, key_block: int, pruning_ratio: float
) -> torch.Tensor:
    """Per-slot effective block budget ``ceil(ceil(len/bk) / ρ)``."""
    live_blocks = (cache_length + key_block - 1) // key_block
    lb = torch.ceil(
        live_blocks.float() / max(pruning_ratio, 1e-6)
    ).to(torch.int32)
    return torch.clamp(lb, min=1)


def _decode_valid_mask(
    q: torch.Tensor, n_k: int, cache_length: torch.Tensor,
    window: Optional[int],
) -> torch.Tensor:
    """Cache-length (+ sliding-window) validity for one-token decode,
    broadcastable to ``[..., n_q, n_k]``."""
    kpos = torch.arange(n_k, device=q.device)[None, :]
    valid = kpos < cache_length[:, None]
    if window is not None and window > 0:
        valid = valid & (kpos >= (cache_length[:, None] - window))
    return valid[:, None, None, :]


def _decode_block_plan(
    cfg: EnergonConfig, n_k: int, cache_length: torch.Tensor
):
    """Static budget, keep_all and per-slot live budget of the block
    decode paths."""
    bk = cfg.decode_key_block
    n_kb = n_k // bk
    budget = max(1, math.ceil(n_kb / cfg.pruning_ratio))
    keep_all = cfg.pruning_ratio <= 1.0
    live_budget = None
    if not keep_all:
        live_budget = decode_live_budget(cache_length, bk, cfg.pruning_ratio)
    return budget, keep_all, live_budget


def _fused_decode_engaged(
    cfg: EnergonConfig, filter_planes_resident: bool, window
) -> bool:
    """The fused decode kernels need resident planes, no window, the
    2-round config and Fig. 7 reuse."""
    return (
        cfg.impl == "pallas"
        and filter_planes_resident
        and window is None
        and len(cfg.round_bits) == 2
        and cfg.reuse_partial
    )


def _prefill_diag_blocks(
    q_positions: torch.Tensor, query_block: int, key_block: int, n_k: int
) -> torch.Tensor:
    """keep_diagonal target per query block at absolute positions:
    ``[B, n_q]`` → ``[B, n_qb]`` = key block of the block's highest real
    row (sentinels ≥ n_k dropped)."""
    n_q = q_positions.shape[-1]
    eff = torch.where(q_positions < n_k, q_positions, -1)
    qb_pos = eff.reshape(eff.shape[0], n_q // query_block, query_block).amax(-1)
    return torch.clamp(qb_pos, 0, n_k - 1) // key_block


def _fused_prefill_engaged(
    cfg: EnergonConfig, filter_planes_resident: bool, window, n_k: int
) -> bool:
    """The fused prefill kernels additionally need a cache divisible
    into the resident plane blocks (the reference's padded-cache
    ``kv_length`` condition is checked by :func:`energon_attention`, its
    one caller that takes ``kv_length``)."""
    return (
        cfg.impl == "pallas"
        and filter_planes_resident
        and window is None
        and len(cfg.round_bits) == 2
        and cfg.reuse_partial
        and cfg.decode_key_block > 0
        and n_k % cfg.decode_key_block == 0
    )


def serving_faults(
    cfg: EnergonConfig, *, group: int, cache_len: int, chunk: int,
    paged: bool = True,
) -> List[str]:
    """Why serving ``chunk``-token prefill chunks (``group`` query heads
    per KV head) against ``cache_len``-row caches — paged, or contiguous
    with ``paged=False`` — would fail mid-run: sparse layers that miss
    the fused kernels' engagement rules raise, and the dense prefix
    layers refuse masks past ``chunk_threshold``. Empty when every layer
    can run."""
    rows = group * chunk
    faults = []
    if (cfg.impl == "dense" or cfg.min_prune_layer > 0) \
            and rows * cache_len > cfg.chunk_threshold:
        faults.append(
            f"dense layers would mask {rows} folded rows × {cache_len} "
            f"keys, past chunk_threshold={cfg.chunk_threshold}: lower the "
            "prefill chunk or max_len")
    if cfg.impl == "dense":
        return faults
    if cfg.impl != "pallas":
        return faults + [f"impl={cfg.impl!r} is not ported yet (the port "
                         "serves impl='pallas')"]
    if not cfg.filter_cache_engages(cache_len):
        threshold = cfg.filter_cache_min_len
        faults.append(
            f"filter planes are resident only from "
            f"{FILTER_CACHE_AUTO_MIN_LEN if threshold is None else threshold}"
            f" cache rows (max_len {cache_len}): raise max_len or set "
            "filter_cache_min_len")
    if paged and cfg.key_block != cfg.decode_key_block:
        faults.append(f"key_block {cfg.key_block} must equal "
                      f"decode_key_block {cfg.decode_key_block}")
    if not paged and (cache_len % cfg.key_block
                      or cache_len // cfg.key_block <= 1):
        faults.append(
            f"the {cache_len} cache rows must divide into two or more "
            f"key blocks of {cfg.key_block} (else the reference falls back "
            "to mpmrf_row)")
    from repro_torch.kernels.mpmrf_decode import (
        DECODE_FILTER_MAX_G, DECODE_FILTER_MAX_KEY_BLOCK,
    )

    if group > DECODE_FILTER_MAX_G:
        faults.append(f"the decode kernels take at most "
                      f"{DECODE_FILTER_MAX_G} query heads per KV head "
                      f"(G={group})")
    dkb = cfg.decode_key_block
    if dkb % 8 or not 0 < dkb <= DECODE_FILTER_MAX_KEY_BLOCK:
        faults.append(f"decode_key_block {dkb} must be a multiple of 8, "
                      f"<= {DECODE_FILTER_MAX_KEY_BLOCK} (the decode "
                      "filter's key tiles)")
    if rows % cfg.query_block:
        faults.append(f"query_block {cfg.query_block} must divide the "
                      f"{rows} folded chunk rows (G={group} × chunk "
                      f"{chunk})")
    if len(cfg.round_bits) != 2 or not cfg.reuse_partial:
        faults.append("the fused kernels take two rounds with reuse_partial")
    return faults


def energon_paged_prefill_attention(
    q: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    block_table: torch.Tensor,
    q_positions: torch.Tensor,
    cfg: EnergonConfig,
    *,
    layer_index: int = 10**9,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    telemetry: bool = False,
):
    """Chunked-prefill attention against the page pool.

    q ``[B, KV, n_q, d]`` folded rows; ``cache`` one layer's pool
    (``k``/``v`` ``[KV, rows, d]`` + ``k_codes``/``k_scale``);
    ``q_positions`` int32 ``[B, n_q]``. When the fused kernels engage the
    chunk attends the pool in place (filter through the block table,
    gather through survivor ∘ block table); otherwise the logical K/V
    view is gathered, zeroed past each slot's written extent, and
    handed to :func:`energon_attention` (the dense prefix layers).
    """
    from repro_torch.runtime import paged_cache as pgc

    ps = cfg.decode_key_block
    if ps <= 0:
        raise ValueError("paged prefill needs decode_key_block > 0")
    mb = block_table.shape[-1]
    n_k = mb * ps
    n_q = q.shape[-2]

    fused = (
        layer_index >= cfg.min_prune_layer
        and _fused_prefill_engaged(cfg, "k_codes" in cache, window, n_k)
        and cfg.key_block == ps
        and n_q % cfg.query_block == 0
        and n_k // cfg.key_block > 1
    )
    if fused:
        from repro_torch.kernels import ops as kops

        n_kb = n_k // cfg.key_block
        return kops.fused_paged_prefill_attention(
            q, cache["k"], cache["v"], cache["k_codes"], cache["k_scale"],
            block_table, q_positions,
            round_bits=cfg.round_bits,
            alphas=cfg.alphas,
            query_block=cfg.query_block,
            key_block=cfg.key_block,
            block_budget=max(1, math.ceil(n_kb / cfg.pruning_ratio)),
            keep_all=cfg.pruning_ratio <= 1.0,
            keep_first=cfg.keep_first,
            keep_diagonal=cfg.keep_diagonal,
            diag_blocks=_prefill_diag_blocks(
                q_positions, cfg.query_block, cfg.key_block, n_k
            ),
            scale=scale,
            telemetry=telemetry,
        )
    if layer_index >= cfg.min_prune_layer and cfg.impl != "dense":
        raise _not_ported(
            f"paged prefill with impl={cfg.impl!r} outside the fused "
            "kernels' engagement rule"
        )

    k_log = pgc.gather_logical_rows(cache["k"], block_table, ps)
    v_log = pgc.gather_logical_rows(cache["v"], block_table, ps)
    # unmapped logical blocks alias page 0 (another occupant's rows):
    # zero the view past each slot's written extent, as the unpaged
    # cache holds zeros there
    extent = torch.where(
        q_positions < n_k, q_positions + 1, 0
    ).amax(dim=1)
    row_ok = (
        torch.arange(n_k, device=q.device)[None, :] < extent[:, None]
    )[:, None, :, None]
    k_log = k_log * row_ok
    v_log = v_log * row_ok
    return energon_attention(
        q, k_log, v_log, cfg,
        causal=True, window=window, layer_index=layer_index,
        q_positions=q_positions, scale=scale, telemetry=telemetry,
    )


def _decode_route(
    cfg: EnergonConfig, n_k: int, layer_index: int, window,
    filter_planes_resident: bool,
) -> str:
    """Which decode branch runs — ``"dense"`` (prefix layers, dense impl,
    ρ ≤ 1 outside the block path) or ``"fused"`` — for either cache
    layout; branches not ported yet raise."""
    if layer_index < cfg.min_prune_layer or cfg.impl == "dense":
        return "dense"
    bk = cfg.decode_key_block
    if (cfg.impl in ("mpmrf_block", "pallas") and bk > 0 and n_k % bk == 0
            and n_k // bk > 1):
        if _fused_decode_engaged(cfg, filter_planes_resident, window):
            return "fused"
        raise _not_ported("the XLA block decode path")
    if cfg.pruning_ratio <= 1.0:
        return "dense"
    raise _not_ported("row-granular MP-MRF decode")


def _fused_decode_kwargs(cfg: EnergonConfig, n_k: int, cache_length,
                         scale, telemetry) -> Dict[str, object]:
    budget, keep_all, live_budget = _decode_block_plan(cfg, n_k, cache_length)
    return dict(
        round_bits=cfg.round_bits,
        alphas=cfg.alphas,
        key_block=cfg.decode_key_block,
        block_budget=budget,
        keep_all=keep_all,
        keep_first=cfg.keep_first,
        keep_diagonal=cfg.keep_diagonal,
        live_budget=live_budget,
        scale=scale,
        telemetry=telemetry,
    )


def energon_paged_decode_attention(
    q: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    block_table: torch.Tensor,
    cache_length: torch.Tensor,
    cfg: EnergonConfig,
    *,
    layer_index: int = 10**9,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    telemetry: bool = False,
):
    """One-token decode attention over the page pool.

    q ``[B, KV, G, d]``; ``cache_length`` int32 ``[B]``. Prefix layers
    (and ``impl="dense"``, and ρ ≤ 1 outside the block path) attend the
    transient logical view densely; sparse layers with resident planes
    run the fused paged kernels.
    """
    from repro_torch.runtime import paged_cache as pgc

    bk = cfg.decode_key_block
    if bk <= 0:
        raise ValueError("paged decode needs decode_key_block > 0")
    n_k = block_table.shape[-1] * bk
    route = _decode_route(cfg, n_k, layer_index, window, "k_codes" in cache)
    if route == "fused":
        from repro_torch.kernels import ops as kops

        return kops.fused_paged_decode_attention(
            q, cache["k"], cache["v"], cache["k_codes"], cache["k_scale"],
            block_table, cache_length,
            **_fused_decode_kwargs(cfg, n_k, cache_length, scale, telemetry),
        )
    valid = _decode_valid_mask(q, n_k, cache_length, window)
    out = spa.dense_attention(
        q,
        pgc.gather_logical_rows(cache["k"], block_table, bk),
        pgc.gather_logical_rows(cache["v"], block_table, bk),
        valid, scale,
    )
    return (out, _zero_stats(q.shape[0], q.device)) if telemetry else out


def energon_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_length: torch.Tensor,
    cfg: EnergonConfig,
    *,
    layer_index: int = 10**9,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    filter_cache: Optional[Dict[str, torch.Tensor]] = None,
    telemetry: bool = False,
):
    """One-token decode attention over the contiguous cache.

    q ``[B, KV, G, d]`` (folded GQA rows, all at one position); caches
    ``[B, KV, n_k, d]``; ``cache_length`` int32 ``[B]`` (an idle slot's
    ``max_len + 1`` sentinel masks nothing); ``filter_cache`` the
    resident planes (``{"codes": int16 [B, KV, n_k, d], "scale": f32
    [B, KV, n_k // cfg.decode_key_block]}``). Prefix layers (and
    ``impl="dense"``, and ρ ≤ 1 outside the block path) attend densely;
    sparse layers with resident planes run the fused kernels (B5 →
    selection → B6).
    """
    n_k = k_cache.shape[-2]
    route = _decode_route(cfg, n_k, layer_index, window,
                          filter_cache is not None)
    if route == "fused":
        from repro_torch.kernels import ops as kops

        return kops.fused_decode_attention(
            q, k_cache, v_cache, filter_cache["codes"], filter_cache["scale"],
            cache_length,
            **_fused_decode_kwargs(cfg, n_k, cache_length, scale, telemetry),
        )
    valid = _decode_valid_mask(q, n_k, cache_length, window)
    out = spa.dense_attention(q, k_cache, v_cache, valid, scale)
    return (out, _zero_stats(q.shape[0], q.device)) if telemetry else out

"""Energon attention dispatch (port of ``repro.core.energon_attention``).

This slice ports the serving main path: the paged entry points
:func:`energon_paged_prefill_attention` and
:func:`energon_paged_decode_attention`, whose fused branches run the
hand-written CUDA kernels through :mod:`repro_torch.kernels.ops`, and
the dense branch of :func:`energon_attention` that the unpruned prefix
layers take. A config that would reach the reference's ``mpmrf_row`` /
``mpmrf_block`` XLA paths (or the unpaged fused kernels) raises
``NotImplementedError``; those wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

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
        f"{what} waits for a later slice of the PyTorch port; this "
        "slice serves impl='pallas' with resident filter planes"
    )


def energon_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: EnergonConfig,
    *,
    q_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    layer_index: int = 10**9,
    scale: Optional[float] = None,
    telemetry: bool = False,
):
    """Chunked-prefill attention ``[B, H, n, d]`` at per-row positions
    ``q_positions`` (int32 ``[B, n_q]``; padding sentinels ≥ n_k are
    wholly masked) — the dense branch the unpruned prefix layers (below
    ``cfg.min_prune_layer``) and ``impl="dense"`` take. Every other
    branch of the reference (block/row MP-MRF, offset-only masks,
    flash-style chunking) waits for a later slice and raises.
    """
    n_q, n_k = q.shape[-2], k.shape[-2]
    impl = "dense" if layer_index < cfg.min_prune_layer else cfg.impl
    if impl != "dense":
        raise _not_ported(f"energon_attention impl={impl!r}")
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
    out = spa.dense_attention(q, k, v, valid, scale)
    if telemetry:
        return out, _zero_stats(q.shape[0], q.device)
    return out


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
    ``kv_length`` condition has no paged caller)."""
    return (
        cfg.impl == "pallas"
        and filter_planes_resident
        and window is None
        and len(cfg.round_bits) == 2
        and cfg.reuse_partial
        and cfg.decode_key_block > 0
        and n_k % cfg.decode_key_block == 0
    )


def paged_serving_faults(
    cfg: EnergonConfig, *, group: int, cache_len: int, chunk: int
) -> List[str]:
    """Why serving ``chunk``-token prefill chunks (``group`` query heads
    per KV head) against ``cache_len``-row paged caches would fail mid-run
    in this slice: sparse layers that miss the fused kernels' engagement
    rules raise, and the dense prefix layers refuse masks past
    ``chunk_threshold``. Empty when every layer can run."""
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
        return faults + [f"impl={cfg.impl!r} is not ported yet (this "
                         "slice serves impl='pallas')"]
    if not cfg.filter_cache_engages(cache_len):
        threshold = cfg.filter_cache_min_len
        faults.append(
            f"filter planes are resident only from "
            f"{FILTER_CACHE_AUTO_MIN_LEN if threshold is None else threshold}"
            f" cache rows (max_len {cache_len}): raise max_len or set "
            "filter_cache_min_len")
    if cfg.key_block != cfg.decode_key_block:
        faults.append(f"key_block {cfg.key_block} must equal "
                      f"decode_key_block {cfg.decode_key_block}")
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
    mb = block_table.shape[-1]
    n_k = mb * bk

    def dense():
        valid = _decode_valid_mask(q, n_k, cache_length, window)
        out = spa.dense_attention(
            q,
            pgc.gather_logical_rows(cache["k"], block_table, bk),
            pgc.gather_logical_rows(cache["v"], block_table, bk),
            valid, scale,
        )
        return (out, _zero_stats(q.shape[0], q.device)) if telemetry else out

    if layer_index < cfg.min_prune_layer or cfg.impl == "dense":
        return dense()

    use_block = cfg.impl in ("mpmrf_block", "pallas") and n_k // bk > 1
    if use_block:
        budget, keep_all, live_budget = _decode_block_plan(
            cfg, n_k, cache_length
        )
        if _fused_decode_engaged(cfg, "k_codes" in cache, window):
            from repro_torch.kernels import ops as kops

            return kops.fused_paged_decode_attention(
                q, cache["k"], cache["v"], cache["k_codes"], cache["k_scale"],
                block_table, cache_length,
                round_bits=cfg.round_bits,
                alphas=cfg.alphas,
                key_block=bk,
                block_budget=budget,
                keep_all=keep_all,
                keep_first=cfg.keep_first,
                keep_diagonal=cfg.keep_diagonal,
                live_budget=live_budget,
                scale=scale,
                telemetry=telemetry,
            )
        raise _not_ported("the XLA block decode path (mpmrf_paged_block_select)")

    if cfg.pruning_ratio <= 1.0:
        return dense()
    raise _not_ported("row-granular MP-MRF decode")

"""Energon attention dispatch (port of ``repro.core.energon_attention``).

Every branch of the reference's dispatch, with its routing predicates,
through the four entry points: :func:`energon_attention` (full-sequence
and at ``q_positions``), :func:`energon_decode_attention`,
:func:`energon_paged_decode_attention` and
:func:`energon_paged_prefill_attention`. ``impl`` is one of

* ``dense`` — dense attention (the unpruned prefix layers take it too);
* ``mpmrf_row`` — per-row MP-MRF and masked sparse attention (also the
  fallback for sequences not divisible into two or more blocks);
* ``mpmrf_block`` — block MP-MRF and the block gathers, in torch (the
  reference's XLA paths);
* ``pallas`` — the hand-written CUDA kernels through
  :mod:`repro_torch.kernels.ops`: B9 + B10 full-sequence, the fused
  prefill / decode kernels where their engagement rules hold, the XLA
  block path elsewhere, as in the reference.

Past ``chunk_threshold`` the full-sequence call takes the chunked path
(:mod:`repro_torch.core.chunked_attention`), which never builds an
``[n_q, n_k]`` tensor. One route differs from the reference's there: a
configured ``impl="pallas"`` call (causal, no window, no ``kv_length``)
runs its sparse layers through B9 → Eq. 3 + top-B → B10 and its dense
prefix layers through B11. The reference lowers that call through its
XLA scan only because its Pallas kernels are a TPU-runtime path; B9
computes exactly the scan's block planes, so the survivor tables are
the same.

Under autograd (grad enabled and q, k or v requiring grad — the rule is
the grad mode, never the device, so the CPU and the card behave alike)
the CUDA kernels, which have no backward, are never entered: the
chunked route takes the torch scan, the reference's own differentiable
route there, and the direct ``pallas`` route raises, as the reference's
``jax.grad`` through its ``pallas_call`` does. Without the refusal the
kernels' outputs would carry no gradient to q/k/v on the card, while
the CPU's plain versions would differentiate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import filtering as flt
from repro_torch.core import quantization as qlib
from repro_torch.core import sparse_attention as spa

# Resident filter planes are allocated only for caches at least this long
# (the reference's measured crossover, kept so one config drives both).
FILTER_CACHE_AUTO_MIN_LEN = 1024
IMPLS = ("dense", "mpmrf_row", "mpmrf_block", "pallas")
#: B11's tiles on the chunked route's dense prefix layers (the
#: reference's ``flash_attention`` defaults)
FLASH_BLOCK = 128


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

    def mpmrf(self, granularity: str,
              n_kb: Optional[int] = None) -> flt.MPMRFConfig:
        """The filter config of a row or block selection (block budget
        ``ceil(n_kb / ρ)``; ρ ≤ 1 keeps everything)."""
        budget = None
        if granularity == "block" and n_kb is not None:
            budget = max(1, math.ceil(n_kb / self.pruning_ratio))
        return flt.MPMRFConfig(
            round_bits=self.round_bits,
            alphas=self.alphas,
            granularity=granularity,
            query_block=self.query_block,
            key_block=self.key_block,
            block_budget=budget,
            keep_first=self.keep_first,
            keep_diagonal=self.keep_diagonal,
            reuse_partial=self.reuse_partial,
            keep_all=self.pruning_ratio <= 1.0,
        )


def _zero_stats(batch: int, device) -> torch.Tensor:
    return torch.zeros((batch, 4), dtype=torch.int32, device=device)


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

    Query row i sits at absolute position ``q_offset + i``, or at
    ``q_positions`` int32 ``[B, n_q]`` (the chunked-prefill call: folded
    GQA rows; padding sentinels ≥ n_k are wholly masked and ignored by
    the caller). ``window`` is a sliding window (≤ 0: unbounded),
    ``kv_length`` int ``[B]`` the true lengths of padded caches.
    ``filter_cache`` (``{"codes": int16 [B, H, n_k, d], "scale": f32
    [B, H, n_k // cfg.decode_key_block]}``) holds the cache's resident
    planes: every block selection reads them instead of re-quantizing
    ``k``, and with ``impl="pallas"`` at ``q_positions`` the fused
    prefill kernels (B7 → selection → B8) run before any ``[n_q, n_k]``
    mask is built. Layers below ``cfg.min_prune_layer`` run dense.

    With ``telemetry`` also returns int32 ``[B, 4]`` selection counts
    (:func:`repro_torch.core.filtering.selection_stats`): the block
    selections measure them; dense, row, chunked and the full-sequence
    kernel path report zeros, as the reference's do.
    """
    n_q, n_k = q.shape[-2], k.shape[-2]

    def ret(out, stats=None):
        if not telemetry:
            return out
        return out, (stats if stats is not None
                     else _zero_stats(q.shape[0], q.device))

    impl = cfg.impl
    if layer_index < cfg.min_prune_layer and impl != "dense":
        impl = "dense"
    # block paths need two or more whole blocks; others fall back to rows
    if impl in ("mpmrf_block", "pallas") and (
            n_q % cfg.query_block or n_k % cfg.key_block
            or n_k // cfg.key_block <= 1):
        impl = "mpmrf_row"

    if (impl == "pallas" and q_positions is not None and causal
            and _fused_prefill_engaged(cfg, filter_cache is not None,
                                       window, kv_length, n_k)):
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

    # the q_positions form has no chunked variant: past the threshold it
    # would materialize [n_q, n_k] masks
    if q_positions is not None and n_q * n_k > cfg.chunk_threshold:
        raise ValueError(
            f"q_positions attention materializes [{n_q}, {n_k}] masks "
            f"past chunk_threshold={cfg.chunk_threshold}; lower the "
            "prefill chunk (or raise chunk_threshold)"
        )
    if n_q * n_k > cfg.chunk_threshold:
        return ret(_chunked_attention(
            q, k, v, cfg, impl, causal=causal, window=window,
            q_offset=q_offset, kv_length=kv_length, scale=scale))

    valid = _full_valid_mask(q, n_k, causal=causal, window=window,
                             q_offset=q_offset, q_positions=q_positions,
                             kv_length=kv_length)

    if impl == "dense":
        return ret(spa.dense_attention(q, k, v, valid, scale))

    if impl == "mpmrf_row":
        res = flt.mpmrf_row_select(q, k, cfg.mpmrf("row"), valid)
        return ret(spa.masked_sparse_attention(q, k, v, res.keep_mask, scale))

    # window, padded-cache and per-row-position masks are not in the
    # full-sequence kernels' contract: pallas takes the XLA block path
    if impl == "mpmrf_block" or (impl == "pallas" and (
            window is not None or kv_length is not None
            or q_positions is not None)):
        diag_blocks = None
        if q_positions is not None:
            diag_blocks = _prefill_diag_blocks(
                q_positions, cfg.query_block, cfg.key_block, n_k)
        # resident planes replace the fresh quantization, so the XLA and
        # the fused selections score the same integer operands
        k_quant = None
        if (filter_cache is not None and cfg.decode_key_block > 0
                and n_k % cfg.decode_key_block == 0):
            k_quant = qlib.blockwise_quantized_view(
                filter_cache["codes"], filter_cache["scale"],
                cfg.decode_key_block)
        res = flt.mpmrf_block_select(
            q, k, cfg.mpmrf("block", n_k // cfg.key_block), valid,
            diag_blocks=diag_blocks, k_quant=k_quant, with_stats=telemetry)
        out = spa.block_gather_attention(
            q, k, v, res.block_indices, valid, cfg.query_block,
            cfg.key_block, scale, block_valid=res.block_valid)
        return ret(out, flt.selection_stats(res) if telemetry else None)

    if impl == "pallas":
        return ret(_pallas_attention(q, k, v, cfg, causal, q_offset, scale))

    raise ValueError(f"unknown Energon impl: {cfg.impl}")


def _full_valid_mask(q, n_k, *, causal, window, q_offset, q_positions,
                     kv_length) -> Optional[torch.Tensor]:
    """The a-priori validity ``[B, H, n_q, n_k]`` of a direct call (None:
    everything valid): causal / sliding window at ``q_offset`` or at
    ``q_positions`` (sentinel rows ≥ n_k wholly invalid, so their scores
    never reach the pooled planes the real rows share), and
    ``kv_length``."""
    n_q = q.shape[-2]
    shape = q.shape[:-2] + (n_q, n_k)
    kpos = torch.arange(n_k, device=q.device)
    valid = None
    if q_positions is not None:
        qpos = q_positions[:, None, :, None]
        valid = qpos < n_k
        if causal:
            valid = valid & (kpos <= qpos)
        if window is not None and window > 0:
            valid = valid & (kpos > qpos - window)
    elif window is not None:
        valid = flt.sliding_window_valid_mask(n_q, n_k, window, q_offset,
                                              device=q.device)
    elif causal:
        valid = flt.causal_valid_mask(n_q, n_k, q_offset, q.device)
    if kv_length is not None:
        in_range = (kpos[None, :] < kv_length.to(q.device)[:, None]
                    )[:, None, None, :]
        valid = in_range if valid is None else valid & in_range
    return None if valid is None else valid.expand(shape)


def _chunked_attention(q, k, v, cfg, impl, *, causal, window, q_offset,
                       kv_length, scale):
    """The chunked path: the kernel route for a configured pallas call
    that is causal with neither window nor ``kv_length`` (B9 + B10 on
    the sparse layers, B11 on the dense prefix), the torch scan of
    :mod:`repro_torch.core.chunked_attention` for every other call."""
    from repro_torch.core import chunked_attention as chk

    n_q, n_k = q.shape[-2], k.shape[-2]
    kernels = (cfg.impl == "pallas" and causal and window is None
               and kv_length is None and not _under_autograd(q, k, v))
    if kernels and impl == "pallas":
        from repro_torch.kernels import ops as kops

        return _over_heads(kops.chunked_block_attention, q, k, v,
                           round_bits=cfg.round_bits, alphas=cfg.alphas,
                           pruning_ratio=cfg.pruning_ratio,
                           query_block=cfg.query_block,
                           key_block=cfg.key_block, causal=True,
                           q_offset=q_offset, keep_first=cfg.keep_first,
                           keep_diagonal=cfg.keep_diagonal, scale=scale)
    if (kernels and impl == "dense" and n_q % FLASH_BLOCK == 0
            and n_k % FLASH_BLOCK == 0):
        from repro_torch.kernels import ops as kops

        return _over_heads(kops.flash_attention, q, k, v, causal=True,
                           q_offset=q_offset, scale=scale)
    if impl in ("mpmrf_block", "pallas"):
        return chk.energon_block_attention_chunked(
            q, k, v, round_bits=cfg.round_bits, alphas=cfg.alphas,
            pruning_ratio=cfg.pruning_ratio, query_block=cfg.query_block,
            key_block=cfg.key_block, causal=causal, window=window,
            q_offset=q_offset, kv_length=kv_length,
            keep_first=cfg.keep_first, keep_diagonal=cfg.keep_diagonal,
            scale=scale)
    # dense / row: chunked dense (row-granular MP-MRF would build
    # token-level masks at this size)
    return chk.dense_attention_chunked(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        kv_length=kv_length, scale=scale)


def _over_heads(fn, q, k, v, **kw):
    """Run a ``[bh, n, d]`` kernel pipeline on ``[B, H, n, d]`` operands.
    The kernels take contiguous rows: one sequence's heads-first view of
    the attention block's heads-last layout reshapes to a strided view,
    not a copy."""
    batch, heads, n_q, d = q.shape
    n_k = k.shape[-2]
    out = fn(q.reshape(batch * heads, n_q, d).contiguous(),
             k.reshape(batch * heads, n_k, d).contiguous(),
             v.reshape(batch * heads, n_k, d).contiguous(), **kw)
    return out.reshape(q.shape)


def _under_autograd(*tensors: torch.Tensor) -> bool:
    """Would autograd record an op on ``tensors``?"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _pallas_attention(q, k, v, cfg, causal, q_offset, scale):
    """The Filtering Unit then the Attention Unit over ``[B·H, n, d]``.
    Refused under autograd: the kernels have no backward."""
    from repro_torch.kernels import ops as kops

    if _under_autograd(q, k, v):
        raise NotImplementedError(
            "impl='pallas' runs the full-sequence CUDA kernels (B9, B10), "
            "which have no backward, as the reference's pallas_call has "
            "no transpose: train with impl='mpmrf_block' (or "
            "'mpmrf_row' / 'dense'), or call the differentiable "
            "kernels.ops.energon_block_attention directly")

    n_k = k.shape[-2]
    budget = max(1, math.ceil((n_k // cfg.key_block) / cfg.pruning_ratio))

    def pipeline(qf, kf, vf):
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
        return kops.block_sparse_attention(
            qf, kf, vf, idx, val,
            query_block=cfg.query_block,
            key_block=cfg.key_block,
            causal=causal,
            q_offset=q_offset,
            scale=scale,
        )

    return _over_heads(pipeline, q, k, v)


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
    """Static budget, keep_all, per-slot live budget and filter config of
    the block decode paths — one derivation for both layouts (paged ≡
    unpaged depends on their lockstep)."""
    bk = cfg.decode_key_block
    n_kb = n_k // bk
    budget = max(1, math.ceil(n_kb / cfg.pruning_ratio))
    keep_all = cfg.pruning_ratio <= 1.0
    live_budget = None
    if not keep_all:
        live_budget = decode_live_budget(cache_length, bk, cfg.pruning_ratio)
    mcfg = flt.MPMRFConfig(
        round_bits=cfg.round_bits,
        alphas=cfg.alphas,
        granularity="block",
        query_block=1,
        key_block=bk,
        block_budget=budget,
        keep_first=cfg.keep_first,
        keep_diagonal=cfg.keep_diagonal,
        reuse_partial=cfg.reuse_partial,
        keep_all=keep_all,
    )
    return budget, keep_all, live_budget, mcfg


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
    cfg: EnergonConfig, filter_planes_resident: bool, window, kv_length,
    n_k: int,
) -> bool:
    """The fused prefill kernels need what the decode ones do, no
    ``kv_length`` (they mask by per-row positions alone) and a cache
    divisible into the resident plane blocks."""
    return (
        _fused_decode_engaged(cfg, filter_planes_resident, window)
        and kv_length is None
        and cfg.decode_key_block > 0
        and n_k % cfg.decode_key_block == 0
    )


def _serving_prefill_fused(cfg: EnergonConfig, *, rows: int, cache_len: int,
                           paged: bool) -> bool:
    """Does a serving prefill chunk of ``rows`` folded rows over
    ``cache_len`` cache rows take the fused kernels on the sparse
    layers (the engagement rules of the two prefill entry points)?"""
    n_k = cache_len
    return (
        _fused_prefill_engaged(cfg, cfg.filter_cache_engages(cache_len),
                               None, None, n_k)
        and rows % cfg.query_block == 0
        and n_k % cfg.key_block == 0
        and n_k // cfg.key_block > 1
        and (not paged or cfg.key_block == cfg.decode_key_block)
    )


def serving_faults(
    cfg: EnergonConfig, *, group: int, cache_len: int, chunk: int,
    paged: bool = True, head_dim: Optional[int] = None,
    dtype: Optional[torch.dtype] = None, cuda_kernels: bool = False,
    windows: Optional[Sequence[int]] = None,
) -> List[str]:
    """Why serving ``chunk``-token prefill chunks (``group`` query heads
    per KV head) against ``cache_len``-row caches — paged, or contiguous
    with ``paged=False`` — would fail mid-run. Empty when every layer can
    run. The reasons:

    * an unknown ``impl``;
    * a prefill whose layers build ``[G·chunk, cache_len]`` masks past
      ``chunk_threshold``: the dense prefix layers, the windowed layers
      (``windows``, per layer, 0 ⇒ global: the fused kernels take no
      window) and every layer the fused prefill kernels do not take;
    * where the fused decode kernels engage, rows or key blocks the
      decode filter (B1 / B5) does not take;
    * with ``cuda_kernels`` (the kernels launch: a CUDA device), every
      ``head_dim``, ``dtype`` or block shape that a fused kernel on the
      path refuses, by the wrappers' own checks. On the CPU the plain
      versions take every shape.
    """
    if cfg.impl not in IMPLS:
        return [f"impl={cfg.impl!r} is not one of {IMPLS}"]
    rows = group * chunk
    faults = []
    fused_prefill = (cfg.impl == "pallas" and _serving_prefill_fused(
        cfg, rows=rows, cache_len=cache_len, paged=paged))
    windowed = windows is not None and any(w > 0 for w in windows)
    if ((cfg.min_prune_layer > 0 or not fused_prefill or windowed)
            and rows * cache_len > cfg.chunk_threshold):
        if not fused_prefill:
            where = ("dense layers" if cfg.impl == "dense"
                     else "prefill layers off the fused kernels")
        elif windowed:
            where = "windowed layers (and the dense prefix)"
        else:
            where = "dense layers"
        faults.append(
            f"{where} would mask {rows} folded rows × {cache_len} "
            f"keys, past chunk_threshold={cfg.chunk_threshold}: lower the "
            "prefill chunk or max_len")
    # the fused kernels run on the global layers past the dense prefix
    fused_layers = windows is None or any(
        w <= 0 for w in windows[cfg.min_prune_layer:])
    fused_decode = fused_layers and _fused_decode_engaged(
        cfg, cfg.filter_cache_engages(cache_len), None)
    decode_faults = _decode_filter_faults(cfg, group) if fused_decode else []
    faults += decode_faults
    if not cuda_kernels or not fused_layers:
        return faults
    from repro_torch.kernels.flash_attention import check_tile_engine
    from repro_torch.kernels.mpmrf_decode import (
        check_decode_filter_launch, check_decode_gather_launch,
    )
    from repro_torch.kernels.mpmrf_filter import check_filter_launch

    checks = []
    if fused_decode and not decode_faults:
        dkb = cfg.decode_key_block
        checks += [
            lambda: check_decode_filter_launch(group, head_dim, dkb,
                                               cfg.round_bits),
            lambda: check_decode_gather_launch(group, head_dim, dkb, dtype),
        ]
    if fused_prefill:
        n_kb = cache_len // cfg.key_block
        budget = max(1, math.ceil(n_kb / cfg.pruning_ratio))
        checks += [
            lambda: check_filter_launch(head_dim, cfg.query_block,
                                        cfg.key_block, cfg.round_bits),
            # B4's kept survivor lists: two ids a slot, a count, a position
            lambda: check_tile_engine(head_dim, dtype, cfg.query_block,
                                      cfg.key_block, 2 * budget + 1),
        ]
    for check in checks:
        try:
            check()
        except ValueError as exc:
            reason = f"the CUDA kernels refuse: {exc}"
            if reason not in faults:
                faults.append(reason)
    return faults


def _decode_filter_faults(cfg: EnergonConfig, group: int) -> List[str]:
    """The decode filter's (B1 / B5) row and key-block limits, refused on
    every device where the fused decode engages."""
    from repro_torch.kernels.mpmrf_decode import (
        DECODE_FILTER_MAX_G, DECODE_FILTER_MAX_KEY_BLOCK,
    )

    faults = []
    if group > DECODE_FILTER_MAX_G:
        faults.append(f"the decode kernels take at most "
                      f"{DECODE_FILTER_MAX_G} query heads per KV head "
                      f"(G={group})")
    dkb = cfg.decode_key_block
    if dkb % 8 or not 0 < dkb <= DECODE_FILTER_MAX_KEY_BLOCK:
        faults.append(f"decode_key_block {dkb} must be a multiple of 8, "
                      f"<= {DECODE_FILTER_MAX_KEY_BLOCK} (the decode "
                      "filter's key tiles)")
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
    handed to :func:`energon_attention` with the gathered resident
    planes, so the fused and the XLA selections read the same codes.
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
        and _fused_prefill_engaged(cfg, "k_codes" in cache, window, None,
                                   n_k)
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
    filter_cache = None
    if "k_codes" in cache:
        # the pool's planes verbatim (not zeroed: the fused kernel reads
        # raw pages too, and blocks past the extent are masked before
        # pooling either way)
        filter_cache = {
            "codes": pgc.gather_logical_rows(cache["k_codes"], block_table,
                                             ps),
            "scale": pgc.gather_logical_scales(cache["k_scale"],
                                               block_table),
        }
    return energon_attention(
        q, k_log, v_log, cfg,
        causal=True, window=window, layer_index=layer_index,
        q_positions=q_positions, scale=scale, filter_cache=filter_cache,
        telemetry=telemetry,
    )


def _fused_decode_kwargs(cfg: EnergonConfig, plan, scale,
                         telemetry) -> Dict[str, object]:
    budget, keep_all, live_budget, _ = plan
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
    """One-token decode attention over the page pool, bit-identical to
    :func:`energon_decode_attention` on the equivalent logical contents.

    q ``[B, KV, G, d]``; ``cache_length`` int32 ``[B]``. Prefix layers
    and ``impl="dense"`` attend the transient logical view densely; the
    block impls run the fused paged kernels where they engage, else the
    block selection over the gathered resident planes and a gather of
    the survivor pages; the row impl (and ρ ≤ 1 outside the block path)
    runs on the logical view zeroed past each slot's length.
    """
    from repro_torch.runtime import paged_cache as pgc

    bk = cfg.decode_key_block
    if bk <= 0:
        raise ValueError("paged decode needs decode_key_block > 0")
    n_k = block_table.shape[-1] * bk
    valid = _decode_valid_mask(q, n_k, cache_length, window)

    def logical(name):
        return pgc.gather_logical_rows(cache[name], block_table, bk)

    def ret(out, stats=None):
        if not telemetry:
            return out
        return out, (stats if stats is not None
                     else _zero_stats(q.shape[0], q.device))

    if layer_index < cfg.min_prune_layer or cfg.impl == "dense":
        return ret(spa.dense_attention(q, logical("k"), logical("v"), valid,
                                       scale))
    if cfg.impl in ("mpmrf_block", "pallas") and n_k // bk > 1:
        plan = _decode_block_plan(cfg, n_k, cache_length)
        if _fused_decode_engaged(cfg, "k_codes" in cache, window):
            from repro_torch.kernels import ops as kops

            return kops.fused_paged_decode_attention(
                q, cache["k"], cache["v"], cache["k_codes"],
                cache["k_scale"], block_table, cache_length,
                **_fused_decode_kwargs(cfg, plan, scale, telemetry),
            )
        res = flt.mpmrf_paged_block_select(
            q, cache, block_table, plan[3], valid, cache_length,
            live_budget=plan[2], with_stats=telemetry)
        out = spa.paged_decode_block_gather_attention(
            q, cache["k"], cache["v"], res.block_indices, res.block_valid,
            block_table, cache_length, bk, window=window, scale=scale)
        return ret(out, flt.selection_stats(res) if telemetry else None)
    if cfg.pruning_ratio <= 1.0:
        return ret(spa.dense_attention(q, logical("k"), logical("v"), valid,
                                       scale))
    # the row selection quantizes K per head over the whole row axis:
    # zero the rows past each slot's length (unmapped blocks alias page
    # 0) as the unpaged cache holds zeros there
    row_ok = (torch.arange(n_k, device=q.device)[None, :]
              < cache_length[:, None])[:, None, :, None]
    k_log = logical("k") * row_ok
    res = flt.mpmrf_row_select(q, k_log, cfg.mpmrf("row"), valid)
    return ret(spa.decode_sparse_attention(q, k_log, logical("v"),
                                           res.keep_mask, scale))


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
    [B, KV, n_k // cfg.decode_key_block]}``). Three sparse paths, as in
    the reference: the fused kernels (B5 → selection → B6; ``pallas``
    with resident planes and no window), the block path (``mpmrf_block``
    / ``pallas`` over whole decode key blocks: select top-B blocks,
    gather only the survivors) and the row path (a token mask over the
    whole cache).
    """
    n_k = k_cache.shape[-2]
    valid = _decode_valid_mask(q, n_k, cache_length, window)

    def ret(out, stats=None):
        if not telemetry:
            return out
        return out, (stats if stats is not None
                     else _zero_stats(q.shape[0], q.device))

    if layer_index < cfg.min_prune_layer or cfg.impl == "dense":
        return ret(spa.dense_attention(q, k_cache, v_cache, valid, scale))
    bk = cfg.decode_key_block
    if (cfg.impl in ("mpmrf_block", "pallas") and bk > 0 and n_k % bk == 0
            and n_k // bk > 1):
        plan = _decode_block_plan(cfg, n_k, cache_length)
        if _fused_decode_engaged(cfg, filter_cache is not None, window):
            from repro_torch.kernels import ops as kops

            return kops.fused_decode_attention(
                q, k_cache, v_cache, filter_cache["codes"],
                filter_cache["scale"], cache_length,
                **_fused_decode_kwargs(cfg, plan, scale, telemetry),
            )
        k_quant = None
        if filter_cache is not None:
            k_quant = qlib.blockwise_quantized_view(
                filter_cache["codes"], filter_cache["scale"], bk)
        res = flt.mpmrf_decode_block_select(
            q, k_cache, plan[3], valid, cache_length, k_quant=k_quant,
            live_budget=plan[2], with_stats=telemetry)
        out = spa.decode_block_gather_attention(
            q, k_cache, v_cache, res.block_indices, res.block_valid,
            cache_length, bk, window=window, scale=scale)
        return ret(out, flt.selection_stats(res) if telemetry else None)
    if cfg.pruning_ratio <= 1.0:
        # ρ ≤ 1: nothing to prune, skip the filter
        return ret(spa.dense_attention(q, k_cache, v_cache, valid, scale))
    res = flt.mpmrf_row_select(q, k_cache, cfg.mpmrf("row"), valid)
    return ret(spa.decode_sparse_attention(q, k_cache, v_cache,
                                           res.keep_mask, scale))


# --------------------------------------------------------------------------
# decode over a cache split along the sequence (a mesh's cache_pspec)
# --------------------------------------------------------------------------


def _part_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                keep: torch.Tensor, scale: float):
    """One part's flash statistics in f32: ``(Σ exp(s − m)·V, m, Σ exp(s −
    m))`` over the keys ``keep`` admits (m NEG_INF where none)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = torch.where(keep, scores, spa.NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.where(keep, torch.exp(scores - m), 0.0)
    return torch.matmul(e, v.float()), m, e.sum(dim=-1, keepdim=True)


def _block_part_stats(q, k, v, block_indices, block_valid, cache_length,
                      bk: int, first_block: int, window, scale: float):
    """:func:`_part_stats` over the survivor blocks one part holds: the
    table's global block ids in ``[first_block, first_block + n_kb_s)``,
    their key positions placed as the single-device gather places
    them."""
    *lead, _, d = q.shape
    n_kb = k.shape[-2] // bk
    idx = block_indices[..., 0, :].long()                 # [..., B]
    local = idx - first_block
    mine = (local >= 0) & (local < n_kb)
    at = local.clamp(0, n_kb - 1)[..., None, None].expand(
        *idx.shape, bk, d)
    kg = torch.take_along_dim(k.reshape(*lead, n_kb, bk, d), at, dim=-3)
    vg = torch.take_along_dim(v.reshape(*lead, n_kb, bk, d), at, dim=-3)
    scores = torch.einsum("...qd,...jkd->...qjk", q.float(),
                          kg.float()) * scale             # [..., n_q, B, bk]
    kpos = idx[..., None, :, None] * bk + torch.arange(bk, device=q.device)
    cl = cache_length.reshape((cache_length.shape[0],)
                              + (1,) * (kpos.dim() - 1))
    keep = ((kpos < cl) & (block_valid[..., 0, :][..., None, :, None] > 0)
            & mine[..., None, :, None])
    if window is not None and window > 0:
        keep = keep & (kpos >= cl - window)
    flat = (*scores.shape[:-2], -1)
    keep = keep.expand(scores.shape).reshape(flat)
    scores = torch.where(keep, scores.reshape(flat), spa.NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.where(keep, torch.exp(scores - m), 0.0)
    out = torch.einsum("...qjk,...jkd->...qd",
                       e.reshape(scores.shape[:-1] + (kg.shape[-3], bk)),
                       vg.float())
    return out, m, e.sum(dim=-1, keepdim=True)


def _parts_share(parts, count: int):
    """A share's place among the ``count`` parts (``collectives.
    share_of``'s ``(n, k)``) where ``parts`` holds its own one, else
    None."""
    return None if len(parts) == count else (count, next(iter(parts)))


def _merge_parts(stats, device, axes, dtype, share) -> torch.Tensor:
    """The parts' ``(out, m, l)`` gathered over ``axes`` and merged by
    log-sum-exp in f32, in part order, rounded once to ``dtype``."""
    from repro_torch.distributed import collectives as col

    gathered = [col.all_gather([s[None] for s in part], 0, [device],
                               axes=axes, share=share)[0]
                for part in zip(*stats)]
    outs, maxes, sums = gathered
    top = maxes.amax(dim=0)
    num = den = None
    for i in range(outs.shape[0]):
        corr = torch.exp(maxes[i] - top)
        num = outs[i] * corr if num is None else num + outs[i] * corr
        den = sums[i] * corr if den is None else den + sums[i] * corr
    return (num / torch.clamp(den, min=1e-30)).to(dtype)


def energon_decode_attention_parts(
    q: torch.Tensor,
    parts: Dict[int, Dict[str, torch.Tensor]],
    count: int,
    cache_length: torch.Tensor,
    cfg: EnergonConfig,
    *,
    axes: Tuple[str, ...],
    k_scale: Optional[torch.Tensor] = None,
    layer_index: int = 10**9,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`energon_decode_attention` over a contiguous cache split
    along the sequence into ``count`` equal parts over the mesh ``axes``
    (``distributed.sharding.kv_cache_pspec``'s 'model', 'data' or
    ``("data", "model")``). ``parts`` maps a part's index to its leaves
    ``{"k", "v"[, "codes", "scale"]}`` ``[B, KV, n_k / count, d]`` on its
    device (its block scales ``[B, KV, n_kb / count]``); the whole
    mesh's program holds every part, a share (``Mesh.share``) its own.
    ``k_scale`` is the whole ``[B, KV, n_kb]`` plane (the cache's spec
    keeps it whole along the sequence). q ``[B, KV, G, d]`` on the row's
    device; returns ``[B, KV, G, d]`` there.

    * The dense prefix layers (and ``dense``, and ρ ≤ 1 off the block
      path): each part's f32 flash statistics over its valid keys.
    * The block path (``mpmrf_block`` / ``pallas`` off the fused
      kernels): each part scores its own key blocks
      (:func:`~repro_torch.core.filtering.decode_round_block_scores`), the
      rounds' block scores ``[B, KV, 1, n_kb / count]`` are all-gathered
      over ``axes``, every part selects the same global blocks by the
      reference's rules (Eq. 3, the tiers, the stable lower-index-first
      ties), and attends over the selected blocks it holds.
    * The row path (``mpmrf_row``, and the block path's fallback): the
      whole cache's per-head int16 scale from the parts' ``max |k|``
      all-gathered (exact), each part's round score planes ``[B, KV, G,
      n_k / count]`` all-gathered over ``axes``, Alg. 2's Eq. 3 rounds
      over the whole row — the single device's keep mask, bit for bit
      —, and each part attends over the keys it holds that survive.
    * The partials merge by log-sum-exp in f32 in part order and round
      once (the last bits differ from one softmax over the whole cache:
      ROADMAP §C).
    * The fused kernels (B5 → selection → B6), and parts that cut key
      blocks, gather the parts over ``axes`` first — as GSPMD
      replicates a custom call's operands — and run the whole cache's
      call.
    """
    from repro_torch.distributed import collectives as col

    any_part = next(iter(parts.values()))
    n_s = any_part["k"].shape[-2]
    n_k = n_s * count
    dev, dtype = q.device, any_part["v"].dtype
    share = _parts_share(parts, count)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)

    def valid_of(s, on):
        kpos = s * n_s + torch.arange(n_s, device=on)[None, :]
        cl = cache_length.to(on)[:, None]
        ok = kpos < cl
        if window is not None and window > 0:
            ok = ok & (kpos >= cl - window)
        return ok[:, None, None, :]

    def gathered(name):
        order = sorted(parts)
        return col.all_gather([parts[s][name] for s in order], -2, [dev],
                              axes=axes, share=share)[0]

    def whole(planes: bool):
        """The whole cache's call over the parts gathered onto q's
        device."""
        return energon_decode_attention(
            q, gathered("k"), gathered("v"), cache_length, cfg,
            layer_index=layer_index, window=window, scale=scale,
            filter_cache=({"codes": gathered("codes"), "scale": k_scale}
                          if planes else None))

    def merged(keep_of):
        """Each part's flash statistics over the keys ``keep_of(s, on)``
        admits, merged."""
        stats = []
        for s in sorted(parts):
            p = parts[s]
            on = p["k"].device
            stats.append(_part_stats(q.to(on), p["k"], p["v"],
                                     keep_of(s, on), scale))
        return _merge_parts([tuple(t.to(dev) for t in st) for st in stats],
                            dev, axes, dtype, share)

    def dense_parts():
        return merged(valid_of)

    if layer_index < cfg.min_prune_layer or cfg.impl == "dense":
        return dense_parts()
    bk = cfg.decode_key_block
    if (cfg.impl in ("mpmrf_block", "pallas") and bk > 0 and n_k % bk == 0
            and n_k // bk > 1):
        planes = "codes" in any_part and k_scale is not None
        if _fused_decode_engaged(cfg, planes, window) or n_s % bk:
            # the fused kernels, or parts that cut key blocks
            return whole(planes)
        res = _select_over_parts(q, parts, count, cache_length, cfg, axes,
                                 window)
        stats = []
        for s in sorted(parts):
            p = parts[s]
            on = p["k"].device
            st = _block_part_stats(
                q.to(on), p["k"], p["v"], res.block_indices.to(on),
                res.block_valid.to(on), cache_length.to(on), bk,
                s * (n_s // bk), window, scale)
            stats.append(tuple(t.to(dev) for t in st))
        return _merge_parts(stats, dev, axes, dtype, share)
    if cfg.pruning_ratio <= 1.0:
        return dense_parts()
    keep = _row_keep_over_parts(q, parts, count, cache_length, cfg, axes,
                                window)                 # the row path
    return merged(lambda s, on: keep[..., s * n_s:(s + 1) * n_s].to(on))


def _row_keep_over_parts(q, parts, count: int, cache_length,
                         cfg: EnergonConfig, axes, window=None
                         ) -> torch.Tensor:
    """The split row path's token keep mask ``[B, KV, G, n_k]`` on q's
    device: the whole cache's per-head ``max |k|`` (the parts' maxima
    all-gathered over ``axes``; a max is exact in any order), each part's
    keys quantized with it and scored on their own
    (:func:`~repro_torch.core.filtering.row_round_scores`), the rounds'
    planes all-gathered, and the whole row's Eq. 3 rounds there
    (:func:`~repro_torch.core.filtering.row_select_from_rounds`)."""
    from repro_torch.distributed import collectives as col

    share = _parts_share(parts, count)
    mcfg = cfg.mpmrf("row")
    dev = q.device
    order = sorted(parts)
    n_k = parts[order[0]]["k"].shape[-2] * count

    def gather(pieces, dim):
        return col.all_gather(pieces, dim, [dev], axes=axes, share=share)[0]

    amax = gather([parts[s]["k"].float().abs().amax(
        dim=(-2, -1), keepdim=True).to(dev) for s in order], -1)
    amax = amax.amax(dim=-1, keepdim=True)
    per_part = []
    for s in order:
        k = parts[s]["k"]
        on = k.device
        k16 = qlib.quantize_int16(k, axis=(-2, -1), absmax=amax.to(on))
        per_part.append(flt.row_round_scores(
            qlib.quantize_int16(q.to(on), axis=-1), k16, mcfg))
    planes = [gather([pp[r].to(dev) for pp in per_part], -1)
              for r in range(len(per_part[0]))]
    valid = _decode_valid_mask(q, n_k, cache_length.to(dev), window)
    return flt.row_select_from_rounds(
        planes, mcfg, valid.expand(q.shape[:-1] + (n_k,))).keep_mask


def _select_over_parts(q, parts, count: int, cache_length,
                       cfg: EnergonConfig, axes, window=None
                       ) -> flt.FilterResult:
    """The split block path's selection: each part scores its own key
    blocks (from its resident planes where it has them), the rounds'
    block scores are all-gathered over ``axes`` onto q's device, and the
    whole cache's rules select there."""
    from repro_torch.distributed import collectives as col

    bk = cfg.decode_key_block
    n_k = next(iter(parts.values()))["k"].shape[-2] * count
    share = _parts_share(parts, count)
    _, _, live_budget, mcfg = _decode_block_plan(cfg, n_k, cache_length)
    per_part = []
    for s in sorted(parts):
        p = parts[s]
        on = p["k"].device
        n_s = p["k"].shape[-2]
        kpos = s * n_s + torch.arange(n_s, device=on)[None, :]
        cl = cache_length.to(on)[:, None]
        valid = kpos < cl
        if window is not None and window > 0:
            valid = valid & (kpos >= cl - window)
        k_quant = None
        if "codes" in p and "scale" in p:
            k_quant = qlib.blockwise_quantized_view(p["codes"], p["scale"],
                                                    bk)
        per_part.append(flt.decode_round_block_scores(
            q.to(on), None if k_quant is not None else p["k"], mcfg,
            valid[:, None, None, :], k_quant=k_quant))
    rounds = [tuple(col.all_gather([pp[r][i].to(q.device) for pp in per_part],
                                   -1, [q.device], axes=axes, share=share)[0]
                    for i in range(2))
              for r in range(len(per_part[0]))]
    return flt.decode_block_select_from_rounds(rounds, mcfg, cache_length,
                                               live_budget=live_budget)


def decode_block_table_parts(q, parts, count, cache_length,
                             cfg: EnergonConfig, *, axes):
    """The survivor table ``(block_indices, block_valid)`` the split
    block path of :func:`energon_decode_attention_parts` selects, for the
    tests and the card's check against the single-device selection."""
    res = _select_over_parts(q, parts, count, cache_length, cfg, axes)
    return res.block_indices, res.block_valid

"""MP-MRF block selection rules (port of ``repro.core.filtering``).

One torch implementation of each selection rule the fused kernels run
between their filter and gather stages: the Eq. 3 threshold, the
prefill top-B selection on pooled block planes and the decode
exact-budget tier selection, plus the telemetry reduction and the
causal mask of the full-sequence path.

Parity with the reference rests on three orderings:

* ``jax.lax.top_k`` puts the lower index first among equal values, so
  top-B here is a *stable* descending sort (``torch.topk`` promises no
  tie order);
* ``jnp.argsort`` is stable, so every argsort passes ``stable=True``;
* the Eq. 3 mean is a float sum whose order differs between the
  frameworks — a block sitting exactly on θ may flip. Selection is
  tested from identical score planes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import quantization as qlib

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class MPMRFConfig:
    """Configuration of Mix-Precision Multi-Round Filtering (see the
    reference for each field)."""

    round_bits: Tuple[int, ...] = (2, 4)
    alphas: Tuple[float, ...] = (0.0, 0.0)
    granularity: str = "row"
    query_block: int = 128
    key_block: int = 128
    block_budget: Optional[int] = None
    keep_first: bool = True
    keep_diagonal: bool = True
    reuse_partial: bool = True
    keep_all: bool = False

    def __post_init__(self):
        if len(self.round_bits) != len(self.alphas):
            raise ValueError("round_bits and alphas must have equal length")
        if any(not (-1.0 < a < 1.0) for a in self.alphas):
            raise ValueError(f"alphas must be in (-1,1), got {self.alphas}")
        bits = list(self.round_bits)
        if bits != sorted(bits) or len(set(bits)) != len(bits):
            raise ValueError(f"round_bits must be strictly increasing: {bits}")
        if self.granularity not in ("row", "block"):
            raise ValueError(f"bad granularity {self.granularity}")

    @property
    def rounds(self) -> int:
        return len(self.round_bits)


def eq3_threshold(
    scores: torch.Tensor, alpha: float, valid: torch.Tensor
) -> torch.Tensor:
    """Dynamic threshold of Eq. 3 over the last axis, ignoring entries
    already pruned or invalid. Returns ``[..., 1]``."""
    count = torch.clamp(valid.sum(dim=-1, keepdim=True, dtype=torch.int32), min=1)
    s_sum = torch.where(valid, scores, 0.0).sum(dim=-1, keepdim=True)
    mean = s_sum / count
    if alpha >= 0.0:
        s_max = torch.where(valid, scores, NEG_INF).amax(dim=-1, keepdim=True)
        return alpha * s_max + (1.0 - alpha) * mean
    s_min = torch.where(valid, scores, -NEG_INF).amin(dim=-1, keepdim=True)
    return -alpha * s_min + (1.0 + alpha) * mean


@dataclasses.dataclass(frozen=True)
class FilterResult:
    """Output of MP-MRF selection.

    ``keep_mask`` bool ``[..., n_q, n_k]`` (row) or ``[..., n_qb, n_kb]``
    (block); ``block_indices`` / ``block_valid`` int32 ``[..., B]``
    survivor table; ``scores`` the final round's scores; ``sel_tier`` (3
    pinned, 2 Eq. 3 survivor, 1 budget fill, 0 unused) and
    ``live_mask`` only for ``with_stats`` callers. ``round_keep`` holds
    each round's survivors before the safeguards and ``round_valid`` the
    validity they are counted against, from which
    :attr:`survivor_fraction` is computed when it is read (so a
    selection that nobody asks it of launches nothing for it).
    """

    keep_mask: torch.Tensor
    block_indices: Optional[torch.Tensor]
    scores: torch.Tensor
    block_valid: Optional[torch.Tensor] = None
    sel_tier: Optional[torch.Tensor] = None
    live_mask: Optional[torch.Tensor] = None
    round_keep: Tuple[torch.Tensor, ...] = ()
    round_valid: Optional[torch.Tensor] = None

    @property
    def survivor_fraction(self) -> torch.Tensor:
        """The paper's per-round pruning ratio: ``[R, ...]`` surviving ÷
        valid keys (or blocks) of each row after each round, the
        denominator ``max(Σ valid, 1)`` (f32, as the reference's int32
        true division). Empty (``scores[..., :0]``) where the selection
        kept no rounds: the fused ops', as in the reference."""
        if self.round_valid is None:
            return self.scores[..., :0]
        denom = torch.clamp(self.round_valid.sum(dim=-1), min=1)
        return torch.stack([m.sum(dim=-1) / denom for m in self.round_keep])


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: descending, and the lower
    index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def one_hot_bool(idx: torch.Tensor, n: int) -> torch.Tensor:
    return idx.long()[..., None] == torch.arange(n, device=idx.device)


def causal_valid_mask(n_q: int, n_k: int, offset: int = 0,
                      device=None) -> torch.Tensor:
    """Causal validity ``[n_q, n_k]``: query row i (at absolute position
    ``offset + i``) may see keys ≤ ``offset + i``."""
    qpos = torch.arange(n_q, device=device)[:, None] + offset
    kpos = torch.arange(n_k, device=device)[None, :]
    return kpos <= qpos


def prefill_block_select_from_planes(
    round_scores: Sequence[torch.Tensor],
    blk_valid: torch.Tensor,
    cfg: MPMRFConfig,
    diag_mask: Optional[torch.Tensor] = None,
    with_stats: bool = False,
) -> FilterResult:
    """Prefill selection on pooled block planes ``[..., n_qb, n_kb]``:
    per round an Eq. 3 threshold with the running keep mask, then the
    keep-first / diagonal safeguards, then top-B of the final round's
    scores restricted to survivors."""
    n_qb, n_kb = round_scores[-1].shape[-2:]
    blk_keep = blk_valid
    blk_scores = None
    per_round = []
    for alpha, blk_scores in zip(cfg.alphas, round_scores):
        if not cfg.keep_all:
            theta = eq3_threshold(blk_scores, alpha, blk_keep)
            blk_keep = blk_keep & (blk_scores >= theta)
        per_round.append(blk_keep)

    pinned_mask = torch.zeros_like(blk_valid)
    if cfg.keep_first:
        blk_keep = blk_keep.clone()
        blk_keep[..., 0] = blk_valid[..., 0]
        pinned_mask[..., 0] = blk_valid[..., 0]
    if cfg.keep_diagonal:
        if diag_mask is None:
            qb_ids = torch.arange(n_qb, device=blk_valid.device)
            diag = torch.clamp(
                (qb_ids * cfg.query_block) // cfg.key_block, max=n_kb - 1
            )
            diag_mask = one_hot_bool(diag, n_kb)
        diag_valid = diag_mask & blk_valid
        blk_keep = blk_keep | diag_valid
        pinned_mask = pinned_mask | diag_valid

    block_indices = block_valid = sel_tier = None
    if cfg.block_budget is not None:
        b = min(cfg.block_budget, n_kb)
        sel_scores = torch.where(blk_keep, blk_scores, NEG_INF)
        top_vals, block_indices = top_k_stable(sel_scores, b)
        block_valid = (top_vals > NEG_INF / 2).to(torch.int32)
        block_indices = torch.where(
            block_valid > 0, block_indices, 0
        ).to(torch.int32)
        if with_stats:
            # prefill selects among survivors only: a selected slot is a
            # safeguard pin (3) or an Eq. 3 survivor (2), never a fill
            sel_pinned = torch.gather(
                pinned_mask.expand(blk_keep.shape), -1, block_indices.long()
            )
            sel_tier = torch.where(
                block_valid > 0, torch.where(sel_pinned, 3, 2), 0
            ).to(torch.int32)

    return FilterResult(
        keep_mask=blk_keep,
        block_indices=block_indices,
        scores=blk_scores,
        block_valid=block_valid,
        sel_tier=sel_tier,
        live_mask=blk_valid if with_stats else None,
        round_keep=tuple(per_round),
        round_valid=blk_valid,
    )


def decode_block_tier_select(
    blk_scores: torch.Tensor,
    blk_keep: torch.Tensor,
    blk_valid: torch.Tensor,
    newest_block: torch.Tensor,
    budget: int,
    *,
    keep_first: bool = True,
    keep_diagonal: bool = True,
    live_budget: Optional[torch.Tensor] = None,
    with_tiers: bool = False,
):
    """Exact-budget decode selection on integer keys
    ``tier·n_kb + (n_kb-1-rank)``: pinned ≫ Eq. 3 survivors ≫ budget
    fill ≫ invalid, by final-round score rank inside a tier. Slots past
    ``live_budget`` are invalid unless pinned. Returns int32
    ``(block_indices, block_valid[, sel_tier])`` ``[..., budget]``."""
    n_kb = blk_scores.shape[-1]
    order = torch.argsort(
        -torch.where(blk_valid, blk_scores, NEG_INF), dim=-1, stable=True
    )
    rank = torch.argsort(order, dim=-1, stable=True)   # rank 0 = best
    tier = blk_valid.to(torch.int64)                    # fill candidates
    tier = torch.where(blk_keep, 2, tier)               # survivors
    kb_ids = torch.arange(n_kb, device=blk_scores.device)
    if keep_first:
        tier = torch.where((kb_ids == 0) & blk_valid, 3, tier)
    if keep_diagonal:
        nb = torch.as_tensor(newest_block, device=blk_scores.device)[..., None]
        tier = torch.where((kb_ids == nb) & blk_valid, 3, tier)

    b = min(budget, n_kb)
    sel_key = tier * n_kb + (n_kb - 1 - rank)
    # keys are distinct (rank is a permutation), so tie order is moot
    top_keys, block_indices = torch.topk(sel_key, b, dim=-1, sorted=True)
    block_valid = top_keys >= n_kb                      # tier >= 1
    if live_budget is not None:
        slot = torch.arange(b, device=blk_scores.device)
        in_live = slot < torch.as_tensor(live_budget)[..., None]
        pinned = top_keys >= 3 * n_kb
        block_valid = block_valid & (in_live | pinned)
    block_valid = block_valid.to(torch.int32)
    block_indices = torch.where(
        block_valid > 0, block_indices, 0
    ).to(torch.int32)
    if with_tiers:
        sel_tier = torch.where(
            block_valid > 0, top_keys // n_kb, 0
        ).to(torch.int32)
        return block_indices, block_valid, sel_tier
    return block_indices, block_valid


def selection_stats(res: FilterResult) -> torch.Tensor:
    """Per-batch block counts of a ``with_stats`` selection: int32
    ``[B, 4]`` = selected / live / pinned / filled, summed over every
    non-leading axis."""
    if res.block_valid is None or res.live_mask is None:
        raise ValueError(
            "selection_stats needs a FilterResult from a "
            "with_stats=True budget-mode selection"
        )
    lead = res.block_valid.shape[0]

    def red(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(lead, -1).to(torch.int32).sum(-1, dtype=torch.int32)

    selected = red(res.block_valid > 0)
    live = red(res.live_mask)
    if res.sel_tier is None:
        pinned = torch.zeros_like(selected)
        filled = torch.zeros_like(selected)
    else:
        pinned = red(res.sel_tier == 3)
        filled = red(res.sel_tier == 1)
    return torch.stack([selected, live, pinned, filled], dim=-1)


# --------------------------------------------------------------------------
# the XLA selection paths: token-level rounds, row and block selection
# --------------------------------------------------------------------------


def _round_score_planes(q16, k16, cfg: MPMRFConfig):
    """Yield the R rounds' real-unit token-score planes ``[..., n_q,
    n_k]``. With ``reuse_partial`` (Fig. 7) the q plane is held at the
    final width and each round adds the k remainder plane onto the
    shifted int32 accumulator; without it every round re-scores."""
    hi_bits = cfg.round_bits[-1]
    if cfg.reuse_partial:
        qp = q16.bit_plane(hi_bits)
        q_max = qlib.plane_max(hi_bits)
        acc = prev_bits = None
        for bits in cfg.round_bits:
            if acc is None:
                acc = qlib.int_qk_matmul(qp, k16.bit_plane(bits),
                                         (q_max, qlib.plane_max(bits)))
            else:
                rem_max = 2 ** (bits - prev_bits) - 1
                acc = (acc << (bits - prev_bits)) + qlib.int_qk_matmul(
                    qp, k16.lsb_remainder(prev_bits, bits), (q_max, rem_max))
            prev_bits = bits
            yield qlib.rescale_scores(
                acc, q16.plane_scale(hi_bits), k16.plane_scale(bits))
    else:
        for bits in cfg.round_bits:
            yield qlib.rescale_scores(
                qlib.int_qk_matmul(q16.bit_plane(bits), k16.bit_plane(bits),
                                   (qlib.plane_max(bits),) * 2),
                q16.plane_scale(bits), k16.plane_scale(bits))


def row_round_scores(q16, k16, cfg: MPMRFConfig) -> List[torch.Tensor]:
    """The R rounds' token-score planes ``[..., n_q, n_k]`` of int16 q
    and k. Each key's score reads its own row and the scales alone, so a
    cache split along the sequence, quantized with the whole cache's
    per-head scale, scores each part on its own and the parts' planes
    concatenate to the whole cache's, bit for bit."""
    return list(_round_score_planes(q16, k16, cfg))


def row_select_from_rounds(planes: Sequence[torch.Tensor], cfg: MPMRFConfig,
                           valid: torch.Tensor) -> FilterResult:
    """Alg. 2's R rounds of Eq. 3 over the rounds' token-score planes
    (:func:`row_round_scores`), ``valid`` (causality / padding, the
    planes' shape) only shrinking, then ``keep_first``: the token-level
    ``keep_mask``."""
    keep = valid
    scores = None
    per_round = []
    for alpha, scores in zip(cfg.alphas, planes):
        if not cfg.keep_all:
            # ">=" so a constant row keeps its max (θ == max)
            keep = keep & (scores >= eq3_threshold(scores, alpha, keep))
        per_round.append(keep)
    if cfg.keep_first:
        first = torch.zeros_like(keep)
        first[..., 0] = True
        keep = keep | (first & valid)
    return FilterResult(keep_mask=keep, block_indices=None, scores=scores,
                        round_keep=tuple(per_round), round_valid=valid)


def mpmrf_row_select(
    q: torch.Tensor,
    k: torch.Tensor,
    cfg: MPMRFConfig,
    valid: Optional[torch.Tensor] = None,
) -> FilterResult:
    """Paper-faithful per-row MP-MRF (Alg. 2): q ``[..., n_q, d]`` with a
    per-row scale, k ``[..., n_k, d]`` with a per-head scale; ``valid``
    bool broadcastable to ``[..., n_q, n_k]``. Returns a token-level
    ``keep_mask``."""
    q16 = qlib.quantize_int16(q, axis=-1)
    k16 = qlib.quantize_int16(k, axis=(-2, -1))
    n_k = k.shape[-2]
    shape = q.shape[:-1] + (n_k,)
    valid = (torch.ones(shape, dtype=torch.bool, device=q.device)
             if valid is None else valid.expand(shape))
    return row_select_from_rounds(_round_score_planes(q16, k16, cfg), cfg,
                                  valid)


def pool_block_scores(
    scores: torch.Tensor, bq: int, bk: int, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token scores ``[..., n_q, n_k]`` → the max over each (bq × bk)
    tile ``[..., n_qb, n_kb]`` and whether the tile has a valid pair."""
    *lead, n_q, n_k = scores.shape
    shape = (*lead, n_q // bq, bq, n_k // bk, bk)
    tile_valid = valid.expand(scores.shape).reshape(shape)
    blk = torch.where(tile_valid, scores.reshape(shape),
                      NEG_INF).amax(dim=(-3, -1))
    return blk, tile_valid.any(dim=-1).any(dim=-2)


def mpmrf_block_select(
    q: torch.Tensor,
    k: torch.Tensor,
    cfg: MPMRFConfig,
    valid: Optional[torch.Tensor] = None,
    diag_blocks: Optional[torch.Tensor] = None,
    k_quant=None,
    with_stats: bool = False,
) -> FilterResult:
    """Block-granular MP-MRF: the rounds at token level, pooled to
    (query block × key block), then :func:`prefill_block_select_from_planes`.
    ``diag_blocks`` int ``[B, n_qb]`` overrides the keep_diagonal target
    (queries at absolute positions); ``k_quant`` (a resident
    :func:`~repro_torch.core.quantization.blockwise_quantized_view`)
    replaces the fresh per-head k quantization."""
    bq, bk = cfg.query_block, cfg.key_block
    n_q, n_k = q.shape[-2], k.shape[-2]
    if n_q % bq or n_k % bk:
        raise ValueError(
            f"sequence ({n_q},{n_k}) not divisible by blocks ({bq},{bk})")
    n_kb = n_k // bk
    q16 = qlib.quantize_int16(q, axis=-1)
    k16 = qlib.quantize_int16(k, axis=(-2, -1)) if k_quant is None \
        else k_quant
    if valid is None:
        valid = torch.ones(q.shape[:-1] + (n_k,), dtype=torch.bool,
                           device=q.device)
    round_scores = []
    blk_valid = None
    for tok_scores in _round_score_planes(q16, k16, cfg):
        blk_scores, blk_valid = pool_block_scores(tok_scores, bq, bk, valid)
        round_scores.append(blk_scores)
    diag_mask = None
    if cfg.keep_diagonal and diag_blocks is not None:
        diag_mask = one_hot_bool(
            torch.clamp(diag_blocks, 0, n_kb - 1), n_kb)[:, None]
    return prefill_block_select_from_planes(
        round_scores, blk_valid, cfg, diag_mask=diag_mask,
        with_stats=with_stats)


def mpmrf_decode_block_select(
    q: torch.Tensor,
    k_cache: Optional[torch.Tensor],
    cfg: MPMRFConfig,
    valid: torch.Tensor,
    cache_length: torch.Tensor,
    k_quant=None,
    live_budget: Optional[torch.Tensor] = None,
    with_stats: bool = False,
) -> FilterResult:
    """Block-granular MP-MRF over a padded cache (decode): k quantized
    per ``cfg.key_block`` rows (or the resident ``k_quant`` view), the
    rounds pooled over every query row (the folded GQA group shares one
    selection), Eq. 3 per round, then the exact-budget
    :func:`decode_block_tier_select`. Returns the survivor table
    ``[..., 1, budget]``."""
    if cfg.block_budget is None:
        raise ValueError("decode block selection needs cfg.block_budget")
    return decode_block_select_from_rounds(
        decode_round_block_scores(q, k_cache, cfg, valid, k_quant), cfg,
        cache_length, live_budget=live_budget, with_stats=with_stats)


def decode_round_block_scores(
    q: torch.Tensor,
    k_cache: Optional[torch.Tensor],
    cfg: MPMRFConfig,
    valid: torch.Tensor,
    k_quant=None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The R rounds' pooled decode block scores and validity, ``(scores,
    valid)`` ``[..., 1, n_kb]`` per round, over the keys given: k
    quantized per ``cfg.key_block`` rows (or the resident ``k_quant``
    view). Each block's score reads its own rows alone, so a cache split
    over the sequence in whole blocks scores each part on its own and
    the parts' scores concatenate to the whole cache's, bit for bit."""
    bk = cfg.key_block
    if k_cache is None and k_quant is None:
        raise ValueError("need k_cache or a resident k_quant view")
    n_q = q.shape[-2]
    n_k = (k_quant.codes if k_cache is None else k_cache).shape[-2]
    if n_k % bk:
        raise ValueError(f"cache length {n_k} not divisible by {bk}")
    valid = valid.expand(q.shape[:-1] + (n_k,))
    q16 = qlib.quantize_int16(q, axis=-1)
    if k_quant is None:
        codes, scales = qlib.quantize_int16_blocks(k_cache, bk)
        k_quant = qlib.blockwise_quantized_view(codes, scales, bk)
    return [pool_block_scores(tok_scores, n_q, bk, valid)
            for tok_scores in _round_score_planes(q16, k_quant, cfg)]


def decode_block_select_from_rounds(
    rounds: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    cfg: MPMRFConfig,
    cache_length: torch.Tensor,
    live_budget: Optional[torch.Tensor] = None,
    with_stats: bool = False,
) -> FilterResult:
    """Eq. 3 per round over the rounds' block scores
    (:func:`decode_round_block_scores`), then the exact-budget
    :func:`decode_block_tier_select`."""
    bk = cfg.key_block
    blk_keep = blk_scores = blk_valid = None
    per_round = []
    for alpha, (blk_scores, blk_valid) in zip(cfg.alphas, rounds):
        if blk_keep is None:
            blk_keep = blk_valid
        if not cfg.keep_all:
            blk_keep = blk_keep & (
                blk_scores >= eq3_threshold(blk_scores, alpha, blk_keep))
        per_round.append(blk_keep)
    batch = cache_length.shape[0]
    tail = (1,) * (blk_scores.dim() - 2)
    newest = ((cache_length - 1) // bk).reshape((batch,) + tail)
    lb = None if live_budget is None else live_budget.reshape(
        (batch,) + tail)
    out = decode_block_tier_select(
        blk_scores, blk_keep, blk_valid, newest, cfg.block_budget,
        keep_first=cfg.keep_first, keep_diagonal=cfg.keep_diagonal,
        live_budget=lb, with_tiers=with_stats)
    block_indices, block_valid = out[:2]
    return FilterResult(
        keep_mask=blk_keep,
        block_indices=block_indices,
        scores=blk_scores,
        block_valid=block_valid,
        sel_tier=out[2] if with_stats else None,
        live_mask=blk_valid if with_stats else None,
        round_keep=tuple(per_round),
        round_valid=blk_valid,
    )


def mpmrf_paged_block_select(
    q: torch.Tensor,
    cache: dict,
    block_table: torch.Tensor,
    cfg: MPMRFConfig,
    valid: torch.Tensor,
    cache_length: torch.Tensor,
    live_budget: Optional[torch.Tensor] = None,
    with_stats: bool = False,
) -> FilterResult:
    """:func:`mpmrf_decode_block_select` over the page pool: the per-slot
    logical view of the resident planes (or of the float keys, without
    them) is gathered through the block table — the gather is exact, so
    paged and unpaged selection are bit-identical."""
    from repro_torch.runtime import paged_cache as pgc

    bk = cfg.key_block
    if "k_codes" in cache:
        k_quant = qlib.blockwise_quantized_view(
            pgc.gather_logical_rows(cache["k_codes"], block_table, bk),
            pgc.gather_logical_scales(cache["k_scale"], block_table), bk)
        return mpmrf_decode_block_select(
            q, None, cfg, valid, cache_length, k_quant=k_quant,
            live_budget=live_budget, with_stats=with_stats)
    return mpmrf_decode_block_select(
        q, pgc.gather_logical_rows(cache["k"], block_table, bk), cfg, valid,
        cache_length, live_budget=live_budget, with_stats=with_stats)


def expand_block_mask(blk_mask: torch.Tensor, bq: int, bk: int
                      ) -> torch.Tensor:
    """A block keep-mask ``[..., n_qb, n_kb]`` at token granularity."""
    return blk_mask.repeat_interleave(bq, dim=-2).repeat_interleave(bk, dim=-1)


def sliding_window_valid_mask(n_q: int, n_k: int, window, offset: int = 0,
                              device=None) -> torch.Tensor:
    """Causal sliding-window validity ``[n_q, n_k]``; ``window <= 0``
    means unbounded (plain causal)."""
    qpos = torch.arange(n_q, device=device)[:, None] + offset
    kpos = torch.arange(n_k, device=device)[None, :]
    causal = kpos <= qpos
    if window <= 0:
        return causal
    return causal & (kpos > qpos - window)

"""MP-MRF block selection rules (port of ``repro.core.filtering``).

One torch implementation of each selection rule the fused paged kernels
run between their filter and gather stages: the Eq. 3 threshold, the
prefill top-B selection on pooled block planes and the decode
exact-budget tier selection, plus the telemetry reduction.

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
from typing import Optional, Sequence, Tuple

import torch

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
    """Output of MP-MRF block selection.

    ``keep_mask`` bool ``[..., n_qb, n_kb]``; ``block_indices`` /
    ``block_valid`` int32 ``[..., B]`` survivor table; ``scores`` the
    final round's block scores; ``sel_tier`` (3 pinned, 2 Eq. 3
    survivor, 1 budget fill, 0 unused) and ``live_mask`` only for
    ``with_stats`` callers. (The reference's per-round survivor
    fractions feed offline benchmarks only and are not ported.)
    """

    keep_mask: torch.Tensor
    block_indices: Optional[torch.Tensor]
    scores: torch.Tensor
    block_valid: Optional[torch.Tensor] = None
    sel_tier: Optional[torch.Tensor] = None
    live_mask: Optional[torch.Tensor] = None


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: descending, and the lower
    index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def one_hot_bool(idx: torch.Tensor, n: int) -> torch.Tensor:
    return idx.long()[..., None] == torch.arange(n, device=idx.device)


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
    for alpha, blk_scores in zip(cfg.alphas, round_scores):
        if not cfg.keep_all:
            theta = eq3_threshold(blk_scores, alpha, blk_keep)
            blk_keep = blk_keep & (blk_scores >= theta)

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

"""Bytes and operations of the Hopper kernels B1–B11, one launch at a time
(the port's counterpart of ``repro.analysis.kernel_traffic``).

The reference prices its Pallas kernels from their BlockSpec geometry.
The port's kernels are hand-written CUDA whose launch geometry is its
own, so each function here gives, for one launch of one kernel family,
``(bytes, operations, peak)``: the bytes the launch must move (each
input read once, each output written once), the operations it must do
on them, and the card's peak rate for their type (the int8 tensor-core
peak for the filters, the bf16 peak for the attention kernels).
:func:`bound_ms` turns a triple into the least time the card could take.

Each function prices in one of two modes:

* **data mode** — given the counts that the run's data sets (live key
  blocks, valid survivor slots, distinct survivor blocks, causal and
  survivor (query, key) pairs; the ``*_count`` helpers below take them
  from the tensors), it is the arithmetic ``chip_smoke.py`` bounds each
  kernel with;
* **shape-only mode** — without them, the reference's conservative
  convention: every budget slot valid, every block below the length
  live, every survivor tile read anew for each query block (no
  residency credit), every row of a prefill chunk seeing every key.
  ``repro_torch.analysis.op_costs`` prices each launch of a walk so,
  which makes the price the same on the card, on the CPU and on the
  meta device.

Byte counts assume the layouts the wrappers take: int32 q planes and
f32 q scales for B1–B8, int8 planes for B9, int16 K codes, int32 tables
and lengths, f32 score planes, and K/V/q/out of ``itemsize`` bytes
(bf16 on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core.performance_model import (
    H100_HBM_BW,
    H100_PEAK_FLOPS_BF16,
    H100_PEAK_OPS_INT8,
)

_F32 = 4
_I32 = 4
_I16 = 2

Traffic = Tuple[int, int, float]        # (bytes, operations, peak rate)


def bound_ms(nbytes: float, ops: float, peak: float) -> Tuple[float, str]:
    """The least time the card could take (ms), and what sets it: the
    larger of bytes over the HBM rate and operations over ``peak``."""
    tb, to = nbytes / H100_HBM_BW * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# the serving kernels: B1/B5, B2/B6 (decode), B3/B7, B4/B8 (prefill)
# ---------------------------------------------------------------------------


def decode_filter(bh: int, g: int, d: int, key_block: int, blocks: int, *,
                  paged: bool, live_blocks: Optional[int] = None) -> Traffic:
    """B1 (``paged``: a ``[bh, blocks]`` block table) / B5 (the contiguous
    cache, ``blocks`` = n_k / key_block): the q plane and scale, the
    lengths, the int16 codes and a scale of every live block, two score
    planes out; 2 rounds × 2 operations per (query row, live key, dim).
    Shape-only: every block live."""
    live = bh * blocks if live_blocks is None else live_blocks
    nbytes = (bh * g * d * _I32 + bh * g * _F32 + bh * _I32
              + live * (key_block * d * _I16 + _F32)
              + 2 * bh * blocks * _F32)
    if paged:
        nbytes += bh * blocks * _I32
    ops = live * g * key_block * d * 2 * 2
    return nbytes, ops, H100_PEAK_OPS_INT8


def decode_gather(bh: int, g: int, d: int, key_block: int, budget: int, *,
                  paged: bool, valid_slots: Optional[int] = None,
                  itemsize: int = 2) -> Traffic:
    """B2 (``paged``: the survivors' table entries read too) / B6: q in
    and out, the survivor table and valid bits, the lengths, K and V of
    every valid survivor block; QKᵀ and PV over them. Shape-only: every
    slot valid."""
    valid = bh * budget if valid_slots is None else valid_slots
    tables = 3 if paged else 2
    nbytes = (2 * bh * g * d * itemsize + tables * bh * budget * _I32
              + bh * _I32 + valid * key_block * d * itemsize * 2)
    flops = valid * g * key_block * d * 2 * 2
    return nbytes, flops, H100_PEAK_FLOPS_BF16


def prefill_filter(bh: int, n_q: int, d: int, query_block: int,
                   key_block: int, blocks: int, *, paged: bool,
                   seen_blocks: Optional[int] = None,
                   pairs: Optional[int] = None) -> Traffic:
    """B3 (``paged``: the block table, one f32 scale a page) / B7 (one f32
    scale a key row): the q plane, scale and positions, the codes of
    every key block some query row of a bh row can see (counted once per
    bh row), two pooled score planes ``[bh, n_q / query_block, blocks]``
    out; 2 rounds × 2 operations per causally admitted (query, key, dim).
    Shape-only: every block seen, every row seeing every key."""
    seen = bh * blocks if seen_blocks is None else seen_blocks
    n_pairs = bh * n_q * blocks * key_block if pairs is None else pairs
    n_qb = n_q // query_block
    nbytes = (bh * n_q * (d * _I32 + _F32 + _I32)
              + 2 * bh * n_qb * blocks * _F32)
    if paged:
        nbytes += bh * blocks * _I32 + seen * (key_block * d * _I16 + _F32)
    else:
        nbytes += seen * key_block * (d * _I16 + _F32)
    ops = n_pairs * d * 2 * 2
    return nbytes, ops, H100_PEAK_OPS_INT8


def prefill_gather(bh: int, n_q: int, d: int, query_block: int,
                   key_block: int, budget: int, *,
                   distinct_blocks: Optional[int] = None,
                   valid_slots: Optional[int] = None,
                   itemsize: int = 2) -> Traffic:
    """B4 / B8: q in and out, the positions, the survivor table and valid
    bits, K and V of every distinct survivor block (the query blocks of
    a bh row share survivors, which the card reads once); a full tile's
    QKᵀ and PV per valid slot. Shape-only: every slot valid, each read
    anew."""
    n_qb = n_q // query_block
    valid = bh * n_qb * budget if valid_slots is None else valid_slots
    distinct = valid if distinct_blocks is None else distinct_blocks
    nbytes = (2 * bh * n_q * d * itemsize + bh * n_q * _I32
              + 2 * bh * n_qb * budget * _I32
              + distinct * key_block * d * itemsize * 2)
    flops = valid * query_block * key_block * d * 2 * 2
    return nbytes, flops, H100_PEAK_FLOPS_BF16


# ---------------------------------------------------------------------------
# the full-sequence kernels: B9, B10, B11
# ---------------------------------------------------------------------------


def causal_pair_count(n_q: int, n_k: int, q_offset: int = 0) -> int:
    """(query, key) pairs the causal mask admits in one bh row: row i
    sees keys 0 .. q_offset + i (at most n_k)."""
    first = q_offset + 1                    # keys row 0 sees, uncapped
    lo = max(0, min(n_q, -first + 1))       # rows that see nothing
    hi = max(lo, min(n_q, n_k - first + 1))  # rows below the cap
    rising = (hi - lo) * first + (hi * (hi - 1) - lo * (lo - 1)) // 2
    return rising + (n_q - hi) * n_k


def sequence_filter(bh: int, n_q: int, n_k: int, d: int, query_block: int,
                    key_block: int, *, causal: bool = True,
                    q_offset: int = 0) -> Traffic:
    """B9: the int8 q plane and k MSB / remainder planes, the q scale, two
    block-max planes out; 2 rounds × 2 operations per admitted (query,
    key, dim). Its work does not depend on the data."""
    pairs = bh * (causal_pair_count(n_q, n_k, q_offset) if causal
                  else n_q * n_k)
    nbytes = (bh * n_q * d + 2 * bh * n_k * d + bh * n_q * _F32
              + 2 * bh * (n_q // query_block) * (n_k // key_block) * _F32)
    return nbytes, pairs * d * 2 * 2, H100_PEAK_OPS_INT8


def block_sparse(bh: int, n_q: int, d: int, query_block: int,
                 key_block: int, budget: int, *,
                 distinct_blocks: Optional[int] = None,
                 survivor_pairs: Optional[int] = None,
                 itemsize: int = 2) -> Traffic:
    """B10: q in and out, the survivor table and valid bits, K and V of
    every distinct survivor block; QKᵀ and PV over the causally admitted
    pairs of the valid survivor tiles. Shape-only: every slot valid and
    read anew, every tile full."""
    slots = bh * (n_q // query_block) * budget
    distinct = slots if distinct_blocks is None else distinct_blocks
    pairs = (slots * query_block * key_block if survivor_pairs is None
             else survivor_pairs)
    nbytes = (2 * bh * n_q * d * itemsize + 2 * slots * _I32
              + distinct * key_block * d * itemsize * 2)
    return nbytes, pairs * d * 2 * 2, H100_PEAK_FLOPS_BF16


def flash(bh: int, n_q: int, n_k: int, d: int, *, causal: bool = True,
          q_offset: int = 0, itemsize: int = 2) -> Traffic:
    """B11: q, K, V in, out; QKᵀ and PV over the admitted pairs."""
    pairs = bh * (causal_pair_count(n_q, n_k, q_offset) if causal
                  else n_q * n_k)
    nbytes = (2 * bh * n_q * d + 2 * bh * n_k * d) * itemsize
    return nbytes, pairs * d * 2 * 2, H100_PEAK_FLOPS_BF16


# ---------------------------------------------------------------------------
# the data mode's counts, from the tensors a launch is given
# ---------------------------------------------------------------------------


def live_block_count(cache_length, key_block: int,
                     max_blocks: Optional[int] = None) -> int:
    """Key blocks below each row's length, summed over the rows (each
    row's count capped at ``max_blocks``: an idle slot's sentinel length
    runs past its cache)."""
    n = (cache_length.long() + key_block - 1) // key_block
    if max_blocks is not None:
        n = n.clamp(max=max_blocks)
    return int(n.sum())


def seen_block_count(q_positions, key_block: int, n_k: int) -> int:
    """Key blocks up to the last live query row's position, per bh row
    (sentinel rows, at positions ≥ n_k, see nothing), summed."""
    import torch

    live = q_positions < n_k
    seen = torch.where(live, q_positions, -1).amax(dim=1)
    return int(((seen.long() + key_block) // key_block).clamp(min=0).sum())


def row_pair_count(q_positions, n_k: int) -> int:
    """Causally admitted (query, key) pairs of chunk rows at
    ``q_positions`` (a row at position p sees p + 1 keys; sentinel rows
    none)."""
    import torch

    live = q_positions < n_k
    return int(torch.where(live, q_positions.long() + 1, 0).sum())


def row_blocks(idx, n_kb: int):
    """A survivor table's blocks as ids unique across its bh rows
    (b·n_kb + idx)."""
    import torch

    b = torch.arange(idx.shape[0], device=idx.device).reshape(
        -1, *([1] * (idx.dim() - 1)))
    return b * n_kb + idx.long()


def distinct_block_count(blocks, valid) -> int:
    """Key blocks a gather must read at least once: the distinct ids
    among the valid slots."""
    import torch

    return int(torch.unique(blocks[valid > 0]).numel())


def survivor_pair_count(idx, val, query_block: int, key_block: int,
                        q_offset: int = 0) -> int:
    """Causally admitted (query, key) pairs inside the valid survivor
    tiles of a ``[bh, n_qb, B]`` table."""
    import torch

    n_qb = idx.shape[1]
    qpos = (q_offset
            + torch.arange(n_qb, device=idx.device)[:, None] * query_block
            + torch.arange(query_block, device=idx.device))
    seen = torch.clamp(qpos[None, :, None, :] - idx.long()[..., None]
                       * key_block + 1, 0, key_block)
    return int((seen.sum(-1) * val).sum())


# ---------------------------------------------------------------------------
# one fused prefill chunk, the reference's breakdown
# ---------------------------------------------------------------------------

# Plane-shaped passes in the shared tier-select glue (Eq. 3 round
# scores -> masks -> per-tier top-k -> survivor compaction), counted as
# full read+write sweeps over the [bh, n_qb, n_kb] score planes (the
# reference's count).
_SELECT_PLANE_SWEEPS = 8


@dataclass(frozen=True)
class PrefillTraffic:
    """Byte breakdown of one fused prefill chunk (filter + select + gather)."""

    quantize_bytes: int
    filter_bytes: int
    select_bytes: int
    gather_bytes: int

    @property
    def total_bytes(self) -> int:
        return (self.quantize_bytes + self.filter_bytes
                + self.select_bytes + self.gather_bytes)


def fused_prefill_traffic(
    *,
    bh: int,
    n_q: int,
    n_k: int,
    d: int,
    query_block: int,
    key_block: int,
    filter_block: int,
    block_budget: int,
    itemsize: int = 2,
) -> PrefillTraffic:
    """HBM bytes of one fused prefill chunk over the contiguous cache
    (B7 → selection → B8).

    The glue terms (``quantize_bytes``: the query quantisation and the
    per-row expansion of the block scales; ``select_bytes``: the tier
    select on the pooled planes and the survivor table out) are the
    reference's, term for term. The kernel terms follow the port's
    launches, not the Pallas BlockSpecs:

    * ``filter_bytes`` — B7's filter engine streams, for each query
      block, the int16 codes and the f32 per-row scales of every key
      tile (no residency across query blocks), and reads the int32 q
      plane, f32 q scales and int32 positions once: the same bytes as
      the reference's BlockSpec count, which has the same revisits.
    * ``gather_bytes`` — B8 reads q and writes out at ``itemsize`` (bf16
      on the card) where the reference moves f32, reads each survivor
      block's K and V at ``itemsize`` where the reference reads f32, and
      reads the survivor table and valid bits once (the reference's
      scalar prefetch, the same count).

    Args as the reference's: ``bh`` folded batch·heads rows, ``n_q``
    chunk rows (a multiple of ``query_block``), ``n_k`` cache rows (a
    multiple of ``key_block`` and ``filter_block``), ``block_budget``
    survivor key blocks per query block.
    """
    if n_q % query_block or n_k % key_block or n_k % filter_block:
        raise ValueError("tile sizes must divide chunk/context lengths")
    n_qb = n_q // query_block
    n_kb = n_k // key_block
    budget = min(block_budget, n_kb)

    q_bytes = bh * n_q * d * _F32
    plane_bytes = bh * n_qb * n_kb * _I32

    # --- host-side query quantisation (the reference's count)
    quantize = q_bytes + (bh * n_q * d * _I32) + (bh * n_q * _F32)
    quantize += (bh * (n_k // filter_block) * _F32) + (bh * n_k * _F32)

    # --- B7: q plane / scale / positions once, codes and row scales per
    # query block, two pooled planes out
    filt = (bh * n_q * d * _I32) + (bh * n_q * _F32) + (bh * n_q * _I32)
    filt += bh * n_qb * n_k * (d * _I16 + _F32)
    filt += 2 * plane_bytes

    # --- the shared tier select (the reference's count)
    select = _SELECT_PLANE_SWEEPS * plane_bytes
    select += 2 * bh * n_qb * budget * _I32

    # --- B8: shape-only (every slot valid, each survivor read anew)
    gather, _, _ = prefill_gather(bh, n_q, d, query_block, key_block,
                                  budget, itemsize=itemsize)

    return PrefillTraffic(
        quantize_bytes=quantize,
        filter_bytes=filt,
        select_bytes=select,
        gather_bytes=gather,
    )

"""The least work of the Energon kernels, for the roofline metrics.

Frozen arithmetic of the benchmark, first copied from the port's
``analysis/kernel_traffic.py`` (B1, B3, B9, B11) and ``analysis/flops.py``
and held here so a change to the program cannot move the yardstick.
Each function gives ``(bytes, operations, peak)`` for one launch: every
input byte the algorithm needs read once, every output byte written once,
the operations it must do on them, and the card's peak for their type.
Where the work depends on the data, it is counted from what these inputs
need (lengths, positions), never the most a launch could touch. The
gathers after a selection the harness cannot see (B2, B4, B10) are
counted at the live budget: ``ceil(ceil(len / bk) / ρ)`` blocks for a
query whose causal prefix holds ``len`` keys, the budget the decode
selection applies, taken from the live blocks that admit the fewest
(query, key) pairs. Eq. 3's two rounds keep about a quarter of the live
blocks, so the budget is near what a selection keeps; it is the
benchmark's fixed measure of the gathers' work, not a bound on it.

Layouts as the kernels take them: int32 q planes and f32 q scales
(B1, B3), int8 planes (B9), int16 K codes, int32 tables and lengths, f32
score planes, and K/V/q/out in bf16.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from perfbench.work.peaks import HBM_BYTES_S, PEAK_BF16, PEAK_INT8

F32 = I32 = 4
I16 = BF16 = 2
Traffic = Tuple[float, float, float]


def bound_s(traffic: Traffic) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak, whichever is longer."""
    nbytes, ops, peak = traffic
    return max(nbytes / HBM_BYTES_S, ops / peak)


def decode_filter(lengths: Iterable[int], kv: int, g: int, d: int,
                  bk: int) -> Traffic:
    """B1, one layer of one decode step over the slots with cache
    ``lengths``: per (slot, KV head) the q plane and scale of G rows, the
    codes of every written key row and the scale of every live block,
    two scores out per live block; per slot its length and its live
    blocks' table entries; two rounds of two operations per (query row,
    key row, dim)."""
    lengths = list(lengths)
    bh = len(lengths) * kv
    rows = sum(lengths) * kv
    live_slot = sum(-(-n // bk) for n in lengths)
    live = live_slot * kv
    nbytes = (bh * g * d * I32 + bh * g * F32 + len(lengths) * I32
              + live_slot * I32 + rows * d * I16 + live * F32
              + 2 * live * F32)
    return nbytes, rows * g * d * 2 * 2, PEAK_INT8


def decode_survivors(n: int, bk: int, rho: float) -> Tuple[int, int]:
    """Decode selection at cache length ``n``: the valid survivor blocks
    (the live budget ``ceil(ceil(n / bk) / ρ)``, or the two pinned blocks
    where that is fewer) and the key rows they hold (the newest block
    only up to the length)."""
    import math

    live = -(-n // bk)
    pins = 1 if live == 1 else 2
    valid = min(live, max(math.ceil(live / rho), pins))
    return valid, (valid - 1) * bk + (n - (live - 1) * bk)


def decode_gather(lengths: Iterable[int], kv: int, g: int, d: int,
                  bk: int, rho: float) -> Traffic:
    """B2, one layer of one decode step: q in and out, each valid
    survivor's table entry, K and V of the valid survivors' written rows;
    QKᵀ and PV over them."""
    lengths = list(lengths)
    bh = len(lengths) * kv
    surv = [decode_survivors(n, bk, rho) for n in lengths]
    rows = sum(r for _, r in surv) * kv
    valid = sum(v for v, _ in surv) * kv
    nbytes = 2 * bh * g * d * BF16 + valid * I32 + rows * d * BF16 * 2
    return nbytes, rows * g * d * 2 * 2, PEAK_BF16


def prefill_filter(chunks: Iterable[Tuple[int, int]], kv: int, g: int,
                   d: int, bq: int, bk: int, chunk: int) -> Traffic:
    """B3, one layer of one prefill wave over the chunks ``(start,
    end)`` of the slots prefilling: per (slot, KV head) the q plane,
    scale and position of its G real folded rows per chunk row, the
    codes of every key row up to the chunk's end and each of those
    blocks' scale, two pooled scores out per (query block, block seen);
    per slot the table entries of the blocks seen; two rounds of two
    operations per causally admitted (query row, key, dim)."""
    chunks = list(chunks)
    rows = sum(e - s for s, e in chunks) * g * kv
    seen_rows = sum(e for _, e in chunks) * kv
    seen_slot = sum(-(-e // bk) for _, e in chunks)
    seen_blocks = seen_slot * kv
    pairs = sum((s + e + 1) * (e - s) // 2 for s, e in chunks) * g * kv
    n_qb = g * chunk // bq
    nbytes = (rows * (d * I32 + F32 + I32) + seen_slot * I32
              + seen_rows * d * I16 + seen_blocks * F32
              + 2 * n_qb * seen_blocks * F32)
    return nbytes, pairs * d * 2 * 2, PEAK_INT8


def causal_pairs(n: int) -> int:
    """(query, key) pairs of a causal sequence of n positions."""
    return n * (n + 1) // 2


def sequence_filter(seqs: int, heads: int, kv: int, n: int, d: int,
                    bq: int, bk: int) -> Traffic:
    """B9 over ``seqs`` sequences of n tokens: the int8 q plane and q scale
    of every (sequence, head) row, the k msb and remainder planes of every
    (sequence, KV head), two block-max scores out per causal tile; two
    rounds of two operations per causal (query, key, dim)."""
    n_qb = n // bq
    tiles = (bq // bk) * n_qb * (n_qb + 1) // 2
    bh = seqs * heads
    nbytes = (bh * n * (d + F32) + 2 * seqs * kv * n * d
              + 2 * bh * tiles * F32)
    return nbytes, bh * causal_pairs(n) * d * 2 * 2, PEAK_INT8


def flash(seqs: int, heads: int, kv: int, n: int, d: int) -> Traffic:
    """B11 over ``seqs`` sequences: q in and out per (sequence, head), K
    and V per (sequence, KV head); QKᵀ and PV over the causal pairs."""
    bh = seqs * heads
    return ((2 * bh + 2 * seqs * kv) * n * d * BF16,
            bh * causal_pairs(n) * d * 2 * 2, PEAK_BF16)


def live_budget(live: int, rho: float) -> int:
    """The live budget over ``live`` causally live key blocks."""
    import math

    return max(1, math.ceil(live / rho))


def block_pairs(positions: Iterable[int], bk: int) -> List[int]:
    """(query, key) pairs the causal mask admits in each key block, for
    query rows at ``positions`` (row p sees keys 0 .. p): one count per
    block up to the last position's."""
    import numpy as np

    pos = np.asarray(list(positions), dtype=np.int64)
    starts = np.arange(int(pos.max()) // bk + 1, dtype=np.int64) * bk
    seen = np.clip(pos[:, None] - starts[None, :] + 1, 0, bk)
    return [int(x) for x in seen.sum(0)]


def budget_pairs(positions: Iterable[int], bk: int, rho: float
                 ) -> Tuple[int, int]:
    """One query block's gather at its live budget: the blocks counted
    and the pairs they admit (those of the live blocks that admit the
    fewest)."""
    pairs = block_pairs(positions, bk)
    count = min(len(pairs), live_budget(len(pairs), rho))
    return count, sum(sorted(pairs)[:count])


def sequence_sparse(seqs: int, heads: int, kv: int, n: int, d: int,
                    bq: int, bk: int, rho: float) -> Traffic:
    """B10 over ``seqs`` sequences of n tokens, every query block of every
    (sequence, head) at its live budget: q in and out, each counted
    block's table entry and valid bit, K and V of the blocks the
    largest budget of a (sequence, KV head) needs at least; QKᵀ and PV
    over the counted blocks' admitted pairs."""
    blocks = pairs = widest = 0
    for qb in range(n // bq):
        c, p = budget_pairs(range(qb * bq, (qb + 1) * bq), bk, rho)
        blocks, pairs, widest = blocks + c, pairs + p, max(widest, c)
    bh = seqs * heads
    nbytes = (2 * bh * n * d * BF16 + 2 * bh * blocks * I32
              + seqs * kv * widest * bk * d * BF16 * 2)
    return nbytes, bh * pairs * d * 2 * 2, PEAK_BF16


def prefill_gather(chunks: Iterable[Tuple[int, int]], kv: int, g: int,
                   d: int, bq: int, bk: int, chunk: int,
                   rho: float) -> Traffic:
    """B4, one layer of one prefill wave over the chunks ``(start, end)``
    of the slots prefilling. A chunk's G query heads of one KV head are
    folded into ``G · chunk`` rows and pooled ``bq`` at a time; each
    query block's real rows gather its live budget. Per (slot, KV head):
    q in and out and the position of every real folded row, each
    counted block's table entry and valid bit, K and V of the rows the
    largest budget of the chunk needs at least; QKᵀ and PV over the
    counted blocks' admitted pairs."""
    rows = blocks = pairs = kv_rows = 0
    for s, e in chunks:
        folded = [s + r % chunk if r % chunk < e - s else None
                  for r in range(g * chunk)]
        widest = 0
        for i in range(0, g * chunk, bq):
            real = [p for p in folded[i:i + bq] if p is not None]
            if not real:
                continue
            c, p = budget_pairs(real, bk, rho)
            blocks, pairs, widest = blocks + c, pairs + p, max(widest, c)
        rows += (e - s) * g
        kv_rows += min(widest * bk, e)
    nbytes = kv * (rows * (2 * d * BF16 + I32) + 2 * blocks * I32
                   + kv_rows * d * BF16 * 2)
    return nbytes, kv * pairs * d * 2 * 2, PEAK_BF16

"""Energon's dynamic sparse attention, written plainly in float32.

This is the benchmark's own statement of what the served and scored
attention computes, from the algorithm (MP-MRF filtering on int16 codes
truncated to 2 and 4 bits, Eq. 3 thresholds, block selection under a
budget, exact attention over the survivors), independent of the program
under test. Every tensor the program derives (codes, scales, survivor
tables) is worked out again here from float32 keys and queries.

Three routes, as the system runs them:

* :func:`score_attention` — a whole sequence scored at once (the
  chunked route of ``LMModel.apply`` and ``loss``): one int16 scale per head over the
  whole sequence, query blocks of ``bq`` rows per head, key blocks of
  ``bk``, the diagonal pin at ``(qb·bq) // bk``, top-B by the last
  round's score among the blocks Eq. 3 kept;
* :func:`serve_attention` — one served sequence: its prompt prefilled
  in chunks of ``chunk`` rows on a grid from position 0, each chunk's
  G query heads of one KV head folded into ``G·chunk`` rows and pooled
  ``bq`` rows at a time, keys quantized one scale per ``bk``-row block
  over the rows written so far; then one decode step per further
  position, the G heads pooled together, budgeted selection in tiers
  (pinned, Eq. 3 survivors, fill) and the live budget
  ``ceil(ceil(len / bk) / ρ)``;
* :func:`dense_causal` — the unpruned leading layers.

The integer products of the filter (operands of at most 4 bits and 128
terms) are exact in any float type with an f32 accumulator: they run as
bf16 matmuls on the card, float32 on the CPU.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30
LEVELS = 32767
#: float32(1 / 32767): scales are ``absmax`` times this f32 constant
INV_LEVELS = torch.tensor(1.0 / LEVELS, dtype=torch.float32).item()
EPS = 1e-8


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -LEVELS, LEVELS).to(
        torch.int32)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scale per row of ``x [..., d]``: ``(codes, scale [..., 1])``."""
    scale = torch.clamp(x.abs().amax(-1, keepdim=True), min=EPS) * INV_LEVELS
    return _codes(x, scale), scale


def quantize_whole(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scale per leading index of ``x [..., n, d]``: ``scale [..., 1,
    1]``."""
    scale = torch.clamp(x.abs().amax((-2, -1), keepdim=True),
                        min=EPS) * INV_LEVELS
    return _codes(x, scale), scale


def quantize_blocks(x: torch.Tensor, bk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scale per ``bk`` rows of ``x [..., n, d]`` (n a multiple of
    bk): ``(codes [..., n, d], scale [..., n // bk])``."""
    *lead, n, d = x.shape
    xb = x.reshape(*lead, n // bk, bk, d)
    scale = torch.clamp(xb.abs().amax((-2, -1), keepdim=True),
                        min=EPS) * INV_LEVELS
    return _codes(xb, scale).reshape(*lead, n, d), scale[..., 0, 0]


def planes(codes: torch.Tensor, lo: int, hi: int):
    """The ``lo``- and ``hi``-bit planes: the top bits of each code."""
    return codes >> (16 - lo), codes >> (16 - hi)


def int_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ bᵀ`` of small integer tensors, as float32."""
    dt = torch.bfloat16 if a.device.type == "cuda" else torch.float32
    return torch.matmul(a.to(dt), b.to(dt).transpose(-1, -2)).float()


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def eq3_keep(scores: torch.Tensor, keep: torch.Tensor, alpha: float
             ) -> torch.Tensor:
    """One Eq. 3 round over the last axis: keep what scores at least
    ``θ = α·max + (1 − α)·mean`` of the entries still kept."""
    count = torch.clamp(keep.sum(-1, keepdim=True), min=1)
    mean = torch.where(keep, scores, 0.0).sum(-1, keepdim=True) / count
    if alpha >= 0.0:
        top = torch.where(keep, scores, NEG_INF).amax(-1, keepdim=True)
        theta = alpha * top + (1.0 - alpha) * mean
    else:
        low = torch.where(keep, scores, -NEG_INF).amin(-1, keepdim=True)
        theta = -alpha * low + (1.0 + alpha) * mean
    return keep & (scores >= theta)


def top_b(scores: torch.Tensor, keep: torch.Tensor, budget: int):
    """The ``budget`` best kept blocks by score, the lower index first
    among equals: ``(indices, valid)``."""
    sel = torch.where(keep, scores, NEG_INF)
    vals, idx = torch.sort(sel, dim=-1, descending=True, stable=True)
    b = min(budget, scores.shape[-1])
    return idx[..., :b], vals[..., :b] > NEG_INF / 2


def _pool(tok: torch.Tensor, valid: torch.Tensor, rows: int, bk: int):
    """Token scores ``[..., R, n]`` → the max over each ``rows × bk``
    tile ``[..., R // rows, n // bk]``, and which tiles hold a valid
    pair."""
    *lead, r, n = tok.shape
    shape = (*lead, r // rows, rows, n // bk, bk)
    v = valid.expand(tok.shape).reshape(shape)
    blk = torch.where(v, tok.reshape(shape), NEG_INF).amax(dim=(-3, -1))
    return blk, v.any(-1).any(-2)


def budget_of(n_kb: int, rho: float) -> int:
    return max(1, math.ceil(n_kb / rho))


# ---------------------------------------------------------------------------
# attention over a key mask
# ---------------------------------------------------------------------------


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Softmax attention of ``q [..., m, d]`` over the keys ``mask [..., m,
    n]`` admits (float32; a row with no key gives zeros)."""
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return torch.matmul(p, v)


def dense_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 rows: int = 1024) -> torch.Tensor:
    """Causal attention of ``q, k, v [H, n, d]`` (positions 0 .. n−1), a
    block of query rows at a time."""
    n = q.shape[-2]
    kpos = torch.arange(n, device=q.device)
    out = []
    for s in range(0, n, rows):
        e = min(s + rows, n)
        qpos = torch.arange(s, e, device=q.device)[:, None]
        out.append(masked_attention(q[:, s:e], k[:, :e], v[:, :e],
                                    kpos[None, :e] <= qpos))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# the scoring route
# ---------------------------------------------------------------------------


def score_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bq: int, bk: int, rho: float,
                    round_bits: Tuple[int, int] = (2, 4),
                    alphas: Tuple[float, float] = (0.0, 0.0),
                    rows: int = 1024) -> torch.Tensor:
    """MP-MRF attention over a whole causal sequence. ``q, k, v [H, n,
    d]``, k and v already repeated for each query head. Returns ``[H, n,
    d]``."""
    h, n, d = q.shape
    lo, hi = round_bits
    n_qb, n_kb = n // bq, n // bk
    rows = max(bq, rows - rows % bq)
    qc, qs = quantize_rows(q)
    kc, ks = quantize_whole(k)
    qp = qc >> (16 - hi)
    k_lo, k_hi = planes(kc, lo, hi)
    kpos = torch.arange(n, device=q.device)
    s0 = torch.full((h, n_qb, n_kb), NEG_INF, device=q.device)
    s1 = s0.clone()
    valid = torch.zeros((h, n_qb, n_kb), dtype=torch.bool, device=q.device)
    for s in range(0, n, rows):
        e = min(s + rows, n)
        ek = -(-e // bk) * bk
        mask = kpos[None, :ek] <= torch.arange(s, e, device=q.device)[:, None]
        for acc_planes, out in ((k_lo, s0), (k_hi, s1)):
            acc = int_products(qp[:, s:e], acc_planes[:, :ek])
            blk, ok = _pool(acc * qs[:, s:e], mask, bq, bk)
            out[:, s // bq:e // bq, :ek // bk] = blk
        valid[:, s // bq:e // bq, :ek // bk] = ok
    # the k scale and the planes' powers of two, applied after pooling
    s0 = torch.where(s0 <= NEG_INF / 2, NEG_INF,
                     s0 * ks * float(2 ** (16 - hi))
                     * float(2 ** (16 - lo)))
    s1 = torch.where(s1 <= NEG_INF / 2, NEG_INF,
                     s1 * ks * float(2 ** (16 - hi))
                     * float(2 ** (16 - hi)))
    keep = eq3_keep(s0, valid, alphas[0])
    keep = eq3_keep(s1, keep, alphas[1])
    keep[..., 0] = valid[..., 0]
    diag = torch.clamp(torch.arange(n_qb, device=q.device) * bq // bk,
                       max=n_kb - 1)
    keep = keep | ((torch.arange(n_kb, device=q.device) == diag[:, None])
                   & valid)
    idx, ok = top_b(s1, keep, budget_of(n_kb, rho))
    # exact attention over each query block's survivors
    kb = k.reshape(h, n_kb, bk, d)
    vb = v.reshape(h, n_kb, bk, d)
    heads = torch.arange(h, device=q.device)[:, None, None]
    offs = torch.arange(bk, device=q.device)
    out = []
    for s in range(0, n, rows):
        e = min(s + rows, n)
        qb = slice(s // bq, e // bq)
        sel, val = idx[:, qb], ok[:, qb]                  # [H, m, B]
        kg = kb[heads, sel].flatten(2, 3)                 # [H, m, B·bk, d]
        vg = vb[heads, sel].flatten(2, 3)
        qpos = torch.arange(s, e, device=q.device).reshape(-1, bq, 1)
        kp = (sel[..., None] * bk + offs).flatten(2)      # [H, m, B·bk]
        ke = val[..., None].expand(*val.shape, bk).flatten(2)
        mask = ke[:, :, None, :] & (kp[:, :, None, :] <= qpos)
        qq = q[:, s:e].reshape(h, -1, bq, d)
        out.append(masked_attention(qq, kg, vg, mask).reshape(h, e - s, d))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# the serving route
# ---------------------------------------------------------------------------


def _prefill_chunk(q, k, v, c0: int, c1: int, *, chunk: int, group: int,
                   cache_rows: int, bq: int, bk: int, rho: float,
                   round_bits, alphas):
    """One prefill chunk ``[c0, c1)``: ``q [c1 − c0, H, d]`` at those
    positions, ``k, v [c1, KV, d]`` (the rows written so far). Returns the
    chunk's attention output ``[c1 − c0, H, d]``."""
    dev = q.device
    lo, hi = round_bits
    kv, d = k.shape[1], k.shape[2]
    real = c1 - c0
    n_live = -(-c1 // bk) * bk
    kk = torch.zeros((kv, n_live, d), device=dev)
    kk[:, :c1] = k.transpose(0, 1)
    vv = torch.zeros_like(kk)
    vv[:, :c1] = v.transpose(0, 1)
    # folded rows (g, c): head kv·G + g at chunk row c; padding rows sit
    # at the sentinel position, past every key
    qf = torch.zeros((kv, group, chunk, d), device=dev)
    qf[:, :, :real] = q.reshape(real, kv, group, d).permute(1, 2, 0, 3)
    qf = qf.reshape(kv, group * chunk, d)
    pos = torch.full((chunk,), cache_rows, device=dev)
    pos[:real] = torch.arange(c0, c1, device=dev)
    qpos = pos.repeat(group)                              # [G·C]
    kpos = torch.arange(n_live, device=dev)
    mask = kpos[None, :] <= qpos[:, None]                 # [G·C, n_live]
    qc, qs = quantize_rows(qf)
    qp = qc >> (16 - hi)
    kc, kscale = quantize_blocks(kk, bk)
    k_rows = torch.repeat_interleave(kscale, bk, dim=-1)[:, None, :]
    k_lo, k_hi = planes(kc, lo, hi)
    rounds = []
    for bits, kplane in ((lo, k_lo), (hi, k_hi)):
        acc = int_products(qp, kplane)
        tok = (acc * (qs * float(2 ** (16 - hi)))) * (
            k_rows * float(2 ** (16 - bits)))
        rounds.append(_pool(tok, mask, bq, bk))
    valid = rounds[0][1]                                  # [KV, n_qb, n_kb]
    keep = valid
    for (blk, _), alpha in zip(rounds, alphas):
        keep = eq3_keep(blk, keep, alpha)
    keep = keep.clone()
    keep[..., 0] = valid[..., 0]
    top = torch.where(qpos < cache_rows, qpos, -1).reshape(-1, bq).amax(-1)
    diag = torch.clamp(top, 0, cache_rows - 1) // bk      # [n_qb]
    keep = keep | ((torch.arange(n_live // bk, device=dev) == diag[:, None])
                   & valid)
    idx, ok = top_b(rounds[1][0], keep, budget_of(cache_rows // bk, rho))
    chosen = torch.zeros_like(keep)
    chosen.scatter_(-1, idx, ok)
    key_ok = torch.repeat_interleave(chosen, bq, dim=-2)
    key_ok = torch.repeat_interleave(key_ok, bk, dim=-1) & mask
    out = masked_attention(qf, kk, vv, key_ok)            # [KV, G·C, d]
    out = out.reshape(kv, group, chunk, d)[:, :, :real]
    return out.permute(2, 0, 1, 3).reshape(real, kv * group, d)


def _decode_steps(q, k, v, first: int, *, group: int, cache_rows: int,
                  bk: int, rho: float, round_bits, alphas):
    """One decode step at each position ``p ≥ first``: ``q [T, H, d]`` at
    positions ``first .. first + T − 1``, ``k, v [N, KV, d]`` with N =
    first + T. Step p sees rows 0 .. p; its newest block is quantized
    over the rows written so far. Returns ``[T, H, d]``."""
    dev = q.device
    lo, hi = round_bits
    t_n = q.shape[0]
    n, kv, d = k.shape
    n_pad = -(-n // bk) * bk
    n_blk = n_pad // bk
    kk = torch.zeros((kv, n_pad, d), device=dev)
    kk[:, :n] = k.transpose(0, 1)
    vv = torch.zeros_like(kk)
    vv[:, :n] = v.transpose(0, 1)
    pos = torch.arange(first, first + t_n, device=dev)    # [T]
    newest = pos // bk
    # each step's newest block over rows up to p (the later rows unwritten)
    rows = newest[:, None] * bk + torch.arange(bk, device=dev)
    part = kk[:, rows] * (rows <= pos[:, None])[None, :, :, None]
    part_codes, part_scale = quantize_blocks(part, bk)    # [KV, T, bk, d]
    full_codes, full_scale = quantize_blocks(kk, bk)      # [KV, n_pad, d]
    qf = q.reshape(t_n, kv, group, d).transpose(0, 1)     # [KV, T, G, d]
    qc, qs = quantize_rows(qf)
    qp = qc >> (16 - hi)
    steps = torch.arange(t_n, device=dev)
    valid = (torch.arange(n_pad, device=dev)[None, :]
             <= pos[:, None])                             # [T, n_pad]
    rounds = []
    for bits in (lo, hi):
        acc = int_products(qp.reshape(kv, t_n * group, d),
                           full_codes >> (16 - bits))
        acc = acc.reshape(kv, t_n, group, n_blk, bk)
        last = int_products(qp, part_codes >> (16 - bits))  # [KV,T,G,bk]
        acc[:, steps, :, newest] = last.permute(1, 0, 2, 3)
        scale = full_scale[:, None, :].expand(kv, t_n, n_blk).clone()
        scale[:, steps, newest] = part_scale[:, :, 0]
        tok = (acc * (qs[..., None] * float(2 ** (16 - hi)))) * (
            scale[:, :, None, :, None] * float(2 ** (16 - bits)))
        tok = tok.reshape(kv, t_n, group, n_pad)
        rounds.append(_pool(tok, valid[None, :, None, :], group, bk))
    blk_valid = rounds[0][1][:, :, 0]                     # [KV, T, n_blk]
    keep = blk_valid
    for (blk, _), alpha in zip(rounds, alphas):
        keep = eq3_keep(blk[:, :, 0], keep, alpha)
    score = rounds[1][0][:, :, 0]
    # tiers: pinned 3 ≫ Eq. 3 survivors 2 ≫ fill 1 ≫ invalid 0, then rank
    n_kb = cache_rows // bk
    order = torch.argsort(-torch.where(blk_valid, score, NEG_INF), dim=-1,
                          stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    tier = torch.where(keep, 2, blk_valid.long())
    ids = torch.arange(n_blk, device=dev)
    pinned = ((ids == 0) | (ids == newest[:, None])) & blk_valid
    tier = torch.where(pinned, 3, tier)
    key = tier * n_kb + (n_kb - 1 - rank)
    budget = min(budget_of(n_kb, rho), n_blk)
    top, idx = torch.topk(key, budget, dim=-1, sorted=True)
    live = torch.clamp(torch.ceil(((pos + 1 + bk - 1) // bk).float() / rho),
                       min=1).long()                      # [T]
    slot = torch.arange(budget, device=dev)
    ok = (top >= n_kb) & ((slot < live[:, None]) | (top >= 3 * n_kb))
    chosen = torch.zeros_like(keep)
    chosen.scatter_(-1, idx, ok)
    key_ok = torch.repeat_interleave(chosen, bk, dim=-1) & valid
    out = masked_attention(qf, kk[:, None], vv[:, None],
                           key_ok[:, :, None, :])         # [KV, T, G, d]
    return out.transpose(0, 1).reshape(t_n, kv * group, d)


def serve_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    prefill: int, chunk: int, cache_rows: int, bq: int,
                    bk: int, rho: float,
                    round_bits: Tuple[int, int] = (2, 4),
                    alphas: Tuple[float, float] = (0.0, 0.0)
                    ) -> torch.Tensor:
    """One served sequence's sparse attention. ``q [N, H, d]``, ``k, v
    [N, KV, d]`` at positions 0 .. N−1; the first ``prefill`` positions
    were prefilled in chunks, the rest decoded one at a time. Returns
    ``[N, H, d]``."""
    n, h, _ = q.shape
    group = h // k.shape[1]
    kw = dict(group=group, cache_rows=cache_rows, bk=bk, rho=rho,
              round_bits=round_bits, alphas=alphas)
    out = []
    for c0 in range(0, prefill, chunk):
        c1 = min(c0 + chunk, prefill)
        out.append(_prefill_chunk(q[c0:c1], k[:c1], v[:c1], c0, c1,
                                  chunk=chunk, bq=bq, **kw))
    if n > prefill:
        out.append(_decode_steps(q[prefill:], k, v, prefill, **kw))
    return torch.cat(out, dim=0)

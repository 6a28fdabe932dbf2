"""MP-MRF decode kernels: B1 / B5 (filter) and B2 / B6 (survivor
gather), over the paged pool and over the contiguous cache.

Each wrapper launches its CUDA kernel (``csrc/mpmrf_decode.cu``) when
its tensors lie on a CUDA device, and runs the plain PyTorch version
beside it when they lie on the CPU — the CPU tests' path. A CUDA tensor
never reaches the plain version through the wrapper; chip runs call the
plain functions directly to hold the kernels against them. The paged and
contiguous twins share their kernel body and their plain version's
arithmetic: a contiguous ``[bh, n_k, d]`` cache is a pool whose block j
of row b is block ``b·n_kb + j``. The gathers split each row's survivor
slots over several blocks (:func:`decode_splits`) and merge the splits'
partials in split order.

Ports of ``repro.kernels.mpmrf_decode.mpmrf_paged_filter_scores``,
``paged_decode_gather_attention``, ``mpmrf_decode_filter_scores`` and
``decode_gather_attention`` (the TPU Pallas kernels).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mpmrf_paged_filter_scores": [_P] * 8 + [_I] * 7 + [_P],
    "mpmrf_decode_filter_scores": [_P] * 7 + [_I] * 7 + [_P],
    "paged_decode_gather_attention": [_P] * 10 + [_I] * 7 + [_F, _P],
    "decode_gather_attention": [_P] * 9 + [_I] * 7 + [_F, _P],
}
FILTER_HEAD_DIMS = (16, 32, 64, 128)
#: survivor slots that one block of the decode gather (B2 / B6) takes,
#: and the most splits of one row (the merge keeps each split's (m, l)
#: in shared memory)
DECODE_SPLIT_SLOTS, DECODE_MAX_SPLITS = 4, 32
#: per (device, stream): the decode gather's f32 workspace and the int32
#: counts its blocks arrive on (one per bh row, zero between calls), each
#: grown on demand
_split_scratch_of: Dict[Tuple[int, int],
                        Tuple[torch.Tensor, torch.Tensor]] = {}


def _lib():
    return _build.load("mpmrf_decode", _SIGNATURES)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        _require(t.device == dev, "all operands must share one device")
        _require(t.is_contiguous(), "operands must be contiguous")
        _require(t.data_ptr() % 16 == 0, "operands must be 16-byte aligned")


# --------------------------------------------------------------------------
# B1: two-round block-max decode scores off the resident page pool
# --------------------------------------------------------------------------


def _filter_scores_plain(q_plane, q_scale, codes, block_scale,
                         cache_length, round_bits, key_block):
    """B1 / B5 on gathered blocks: codes int16 ``[bh, mb, bk, d]``, their
    scales ``[bh, mb]``. Bit-exact: integer dots in float64, which holds
    these small-integer sums exactly, and the reference's rescale
    association."""
    lo, hi = round_bits
    _, mb, bk, _ = codes.shape
    codes = codes.to(torch.int32)
    msb = codes >> (16 - lo)
    rem = (codes >> (16 - hi)) - (msb << (hi - lo))
    qp = q_plane.to(torch.float64)
    acc0 = torch.einsum("bgd,bjkd->bjgk", qp, msb.to(torch.float64))
    accr = torch.einsum("bgd,bjkd->bjgk", qp, rem.to(torch.float64))
    acc0 = acc0.round().to(torch.int32)
    acc1 = (acc0 << (hi - lo)) + accr.round().to(torch.int32)
    qs = (q_scale.float() * float(2 ** (16 - hi)))[:, None]   # [bh,1,g,1]
    ks = block_scale.float()[..., None, None]                 # [bh,mb,1,1]
    s0 = (acc0.float() * qs) * (ks * float(2 ** (16 - lo)))
    s1 = (acc1.float() * qs) * (ks * float(2 ** (16 - hi)))
    kpos = (torch.arange(mb, device=qp.device)[:, None] * key_block
            + torch.arange(bk, device=qp.device)[None, :])      # [mb, bk]
    ok = (kpos[None] < cache_length.long()[:, None, None])[:, :, None, :]
    s0 = torch.where(ok, s0, NEG_INF).amax(dim=(-2, -1))
    s1 = torch.where(ok, s1, NEG_INF).amax(dim=(-2, -1))
    return s0, s1


def paged_filter_scores_plain(
    q_plane, q_scale, k_codes_pages, k_page_scale, block_table,
    cache_length, *, round_bits=(2, 4), key_block=64,
):
    """Plain PyTorch version of B1 (bit-exact)."""
    bt = block_table.long()
    return _filter_scores_plain(
        q_plane, q_scale, k_codes_pages[bt], k_page_scale.reshape(-1)[bt],
        cache_length, round_bits, key_block,
    )


def paged_filter_scores(
    q_plane: torch.Tensor,
    q_scale: torch.Tensor,
    k_codes_pages: torch.Tensor,
    k_page_scale: torch.Tensor,
    block_table: torch.Tensor,
    cache_length: torch.Tensor,
    *,
    round_bits: Tuple[int, int] = (2, 4),
    key_block: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-round block-max decode scores off the page pool (B1).

    q_plane int32 ``[bh, G, d]``; q_scale f32 ``[bh, G, 1]``;
    k_codes_pages int16 ``[P, bk, d]`` (KV heads folded into pages);
    k_page_scale f32 ``[P, 1]``; block_table int32 ``[bh, mb]``
    (head-offset); cache_length int32 ``[bh]``. Returns ``(s0, s1)`` f32
    ``[bh, mb]``; blocks wholly past the length are NEG_INF.
    """
    if q_plane.device.type == "cpu":
        return paged_filter_scores_plain(
            q_plane, q_scale, k_codes_pages, k_page_scale, block_table,
            cache_length, round_bits=round_bits, key_block=key_block,
        )
    _require(q_plane.is_cuda, f"unsupported device {q_plane.device}")
    lo, hi = round_bits
    bh, g, d = q_plane.shape
    mb = block_table.shape[-1]
    _require(hi <= 8 and lo < hi, "plane widths must satisfy lo < hi <= 8")
    _require(d in FILTER_HEAD_DIMS, f"head_dim {d} not in {FILTER_HEAD_DIMS}")
    _require(256 % key_block == 0, f"key_block {key_block} must divide 256")
    _require(tuple(k_codes_pages.shape[1:]) == (key_block, d),
             "k_codes_pages must be [P, key_block, d]")
    _require(q_plane.dtype == torch.int32 and k_codes_pages.dtype == torch.int16
             and block_table.dtype == torch.int32
             and cache_length.dtype == torch.int32,
             "dtypes: q_plane/block_table/cache_length int32, codes int16")
    q_scale = q_scale.float().contiguous()
    k_page_scale = k_page_scale.float().contiguous()
    _check_cuda(q_plane, q_scale, k_codes_pages, k_page_scale, block_table,
                cache_length)
    s0 = torch.empty((bh, mb), dtype=torch.float32, device=q_plane.device)
    s1 = torch.empty_like(s0)
    fn = _lib().mpmrf_paged_filter_scores
    _build.count_launch("mpmrf_paged_filter_scores")
    _build.check(fn(
        _build.ptr(q_plane), _build.ptr(q_scale), _build.ptr(k_codes_pages),
        _build.ptr(k_page_scale), _build.ptr(block_table),
        _build.ptr(cache_length), _build.ptr(s0), _build.ptr(s1),
        bh, g, d, key_block, mb, lo, hi, _build.stream_ptr(q_plane.device),
    ), "mpmrf_paged_filter_scores")
    return s0, s1


# --------------------------------------------------------------------------
# B2: survivor-table decode attention over the page pool
# --------------------------------------------------------------------------


def decode_split_slots(budget: int) -> int:
    """Survivor slots per split of the decode gather (B2 / B6): runs of
    DECODE_SPLIT_SLOTS consecutive slots, one block each, longer only
    where the budget would need more than DECODE_MAX_SPLITS of them. The
    serving path's budget 16 over 64 bh rows gives 4 splits, 256 blocks:
    about two per SM of an H100. The rule reads the budget alone, not bh
    nor the device, so a row's output never depends on the batch it was
    decoded in."""
    return max(DECODE_SPLIT_SLOTS, -(-budget // DECODE_MAX_SPLITS))


def decode_splits(budget: int) -> int:
    """Splits of each bh row's ``budget`` slots (the last may be short;
    at least one, also for an empty table)."""
    return max(1, -(-budget // decode_split_slots(budget)))


def decode_workspace_floats(bh: int, g: int, d: int, budget: int) -> int:
    """f32 workspace of one decode gather call: each split's partials of
    its G rows, the unnormalised accumulator (d) and (m, l)."""
    return bh * decode_splits(budget) * g * (d + 2)


def _split_scratch(q, bh, g, d, budget):
    """The split decode gather's workspace and row counts on the current
    stream, and that stream's handle. Calls on one stream run in order,
    so they can share both; the row's last block merges its splits and
    sets its count back to 0, so the counts stay zero between calls. Each
    stream has its own pair, so calls on two streams never share one."""
    stream = torch.cuda.current_stream(q.device).cuda_stream
    key = (q.device.index, stream)
    floats = decode_workspace_floats(bh, g, d, budget)
    work, count = _split_scratch_of.get(key, (None, None))
    if work is None or work.numel() < floats:
        work = torch.empty(floats, dtype=torch.float32, device=q.device)
    if count is None or count.numel() < bh:
        count = torch.zeros(bh, dtype=torch.int32, device=q.device)
    _split_scratch_of[key] = work, count
    return work, count, stream


def _decode_gather_plain(q, k_blocks, v_blocks, block_indices, block_valid,
                        cache_length, key_block, scale, out_dtype):
    """B2 / B6 on the gathered survivor blocks ``[bh, S, bk, d]``: softmax
    with the kernels' masking rules (f32 math, output in ``out_dtype``)."""
    bh, _, d = q.shape
    bk = key_block
    sm_scale = scale if scale is not None else 1.0 / (d ** 0.5)
    idx = block_indices.long()
    k = k_blocks.float().reshape(bh, -1, d)                     # [bh, S·bk, d]
    v = v_blocks.float().reshape(bh, -1, d)
    s = torch.matmul(q.float(), k.transpose(-1, -2)) * sm_scale  # [bh, g, S·bk]
    kpos = (idx[:, :, None] * bk
            + torch.arange(bk, device=q.device)).reshape(bh, -1)
    ok = (block_valid[:, :, None] > 0).expand(-1, -1, bk).reshape(bh, -1)
    ok = ok & (kpos < cache_length.long()[:, None])
    s = torch.where(ok[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v) / torch.clamp(l, min=1e-30)
    return out.to(out_dtype)


def paged_decode_gather_attention_plain(
    q, k_pages, v_pages, block_indices, block_valid, block_table,
    cache_length, *, key_block=64, scale=None,
):
    """Plain PyTorch version of B2: softmax over the gathered survivor
    pages with the kernel's masking rules."""
    pages = torch.gather(block_table.long(), 1, block_indices.long())
    return _decode_gather_plain(
        q, k_pages[pages], v_pages[pages], block_indices, block_valid,
        cache_length, key_block, scale, v_pages.dtype,
    )


def paged_decode_gather_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_indices: torch.Tensor,
    block_valid: torch.Tensor,
    block_table: torch.Tensor,
    cache_length: torch.Tensor,
    *,
    key_block: int = 64,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Two-level survivor-table decode attention (B2).

    q ``[bh, G, d]``; k_pages/v_pages ``[P, bk, d]``; block_indices /
    block_valid int32 ``[bh, budget]`` (logical survivor ids + valid
    bits); block_table int32 ``[bh, mb]``; cache_length int32 ``[bh]``.
    Returns ``[bh, G, d]`` in V's dtype.
    """
    if q.device.type == "cpu":
        return paged_decode_gather_attention_plain(
            q, k_pages, v_pages, block_indices, block_valid, block_table,
            cache_length, key_block=key_block, scale=scale,
        )
    _require(q.is_cuda, f"unsupported device {q.device}")
    bh, g, d = q.shape
    budget = block_indices.shape[-1]
    mb = block_table.shape[-1]
    _require(q.dtype == k_pages.dtype == v_pages.dtype == torch.bfloat16,
             "the CUDA gather kernel takes bfloat16 q/K/V")
    _require(g <= 16 and d <= 128 and d % 8 == 0,
             f"needs G <= 16 and head_dim <= 128, divisible by 8 (G={g}, d={d})")
    _require(key_block % 4 == 0, "key_block must be a multiple of 4")
    _require(tuple(k_pages.shape[1:]) == (key_block, d),
             "K/V pages must be [P, key_block, d]")
    _require(block_indices.dtype == block_valid.dtype == block_table.dtype
             == cache_length.dtype == torch.int32, "index operands are int32")
    _check_cuda(q, k_pages, v_pages, block_indices, block_valid, block_table,
                cache_length)
    sm_scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    work, count, stream = _split_scratch(q, bh, g, d, budget)
    fn = _lib().paged_decode_gather_attention
    _build.count_launch("paged_decode_gather_attention")
    _build.check(fn(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(block_indices), _build.ptr(block_valid),
        _build.ptr(block_table), _build.ptr(cache_length), _build.ptr(out),
        _build.ptr(work), _build.ptr(count), bh, g, d, key_block, budget, mb,
        decode_split_slots(budget), float(sm_scale), ctypes.c_void_p(stream),
    ), "paged_decode_gather_attention")
    return out


# --------------------------------------------------------------------------
# B5: two-round block-max decode scores off the contiguous filter cache
# --------------------------------------------------------------------------


def _cache_blocks(x: torch.Tensor, key_block: int) -> torch.Tensor:
    """``[bh, n_k, ...]`` cache → ``[bh, n_kb, bk, ...]`` blocks."""
    bh, n_k = x.shape[:2]
    _require(n_k % key_block == 0,
             f"cache rows {n_k} not divisible by {key_block}")
    return x.reshape(bh, n_k // key_block, key_block, *x.shape[2:])


def mpmrf_decode_filter_scores_plain(
    q_plane, q_scale, k_codes, k_block_scale, cache_length, *,
    round_bits=(2, 4), key_block=64,
):
    """Plain PyTorch version of B5 (bit-exact, B1's arithmetic)."""
    return _filter_scores_plain(
        q_plane, q_scale, _cache_blocks(k_codes, key_block), k_block_scale,
        cache_length, round_bits, key_block,
    )


def mpmrf_decode_filter_scores(
    q_plane: torch.Tensor,
    q_scale: torch.Tensor,
    k_codes: torch.Tensor,
    k_block_scale: torch.Tensor,
    cache_length: torch.Tensor,
    *,
    round_bits: Tuple[int, int] = (2, 4),
    key_block: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-round block-max decode scores off the contiguous cache (B5).

    q_plane int32 ``[bh, G, d]``; q_scale f32 ``[bh, G, 1]``; k_codes
    int16 ``[bh, n_k, d]``; k_block_scale f32 ``[bh, n_kb]``;
    cache_length int32 ``[bh]`` (values past n_k mask nothing). Returns
    ``(s0, s1)`` f32 ``[bh, n_kb]``; blocks wholly past the length are
    NEG_INF.
    """
    if q_plane.device.type == "cpu":
        return mpmrf_decode_filter_scores_plain(
            q_plane, q_scale, k_codes, k_block_scale, cache_length,
            round_bits=round_bits, key_block=key_block,
        )
    _require(q_plane.is_cuda, f"unsupported device {q_plane.device}")
    lo, hi = round_bits
    bh, g, d = q_plane.shape
    n_k = k_codes.shape[-2]
    _require(n_k % key_block == 0,
             f"cache rows {n_k} not divisible by {key_block}")
    n_kb = n_k // key_block
    _require(hi <= 8 and lo < hi, "plane widths must satisfy lo < hi <= 8")
    _require(d in FILTER_HEAD_DIMS, f"head_dim {d} not in {FILTER_HEAD_DIMS}")
    _require(256 % key_block == 0, f"key_block {key_block} must divide 256")
    _require(tuple(k_codes.shape) == (bh, n_k, d)
             and tuple(k_block_scale.shape) == (bh, n_kb),
             "k_codes must be [bh, n_k, d] and k_block_scale [bh, n_kb]")
    _require(q_plane.dtype == torch.int32 and k_codes.dtype == torch.int16
             and cache_length.dtype == torch.int32,
             "dtypes: q_plane/cache_length int32, codes int16")
    q_scale = q_scale.float().contiguous()
    k_block_scale = k_block_scale.float().contiguous()
    _check_cuda(q_plane, q_scale, k_codes, k_block_scale, cache_length)
    s0 = torch.empty((bh, n_kb), dtype=torch.float32, device=q_plane.device)
    s1 = torch.empty_like(s0)
    fn = _lib().mpmrf_decode_filter_scores
    _build.count_launch("mpmrf_decode_filter_scores")
    _build.check(fn(
        _build.ptr(q_plane), _build.ptr(q_scale), _build.ptr(k_codes),
        _build.ptr(k_block_scale), _build.ptr(cache_length), _build.ptr(s0),
        _build.ptr(s1), bh, g, d, key_block, n_kb, lo, hi,
        _build.stream_ptr(q_plane.device),
    ), "mpmrf_decode_filter_scores")
    return s0, s1


# --------------------------------------------------------------------------
# B6: survivor-table decode attention over the contiguous cache
# --------------------------------------------------------------------------


def decode_gather_attention_plain(
    q, k_cache, v_cache, block_indices, block_valid, cache_length, *,
    key_block=64, scale=None,
):
    """Plain PyTorch version of B6 (B2's arithmetic on the contiguous
    cache's survivor blocks)."""
    rows = torch.arange(q.shape[0], device=q.device)[:, None]
    idx = block_indices.long()
    return _decode_gather_plain(
        q, _cache_blocks(k_cache, key_block)[rows, idx],
        _cache_blocks(v_cache, key_block)[rows, idx], block_indices,
        block_valid, cache_length, key_block, scale, v_cache.dtype,
    )


def decode_gather_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_indices: torch.Tensor,
    block_valid: torch.Tensor,
    cache_length: torch.Tensor,
    *,
    key_block: int = 64,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Survivor-table decode attention over the contiguous cache (B6).

    q ``[bh, G, d]``; k_cache/v_cache ``[bh, n_k, d]``; block_indices /
    block_valid int32 ``[bh, budget]``; cache_length int32 ``[bh]``.
    Returns ``[bh, G, d]`` in V's dtype.
    """
    if q.device.type == "cpu":
        return decode_gather_attention_plain(
            q, k_cache, v_cache, block_indices, block_valid, cache_length,
            key_block=key_block, scale=scale,
        )
    _require(q.is_cuda, f"unsupported device {q.device}")
    bh, g, d = q.shape
    n_k = k_cache.shape[-2]
    budget = block_indices.shape[-1]
    _require(q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16,
             "the CUDA gather kernel takes bfloat16 q/K/V")
    _require(g <= 16 and d <= 128 and d % 8 == 0,
             f"needs G <= 16 and head_dim <= 128, divisible by 8 (G={g}, d={d})")
    _require(key_block % 4 == 0 and n_k % key_block == 0,
             f"key_block {key_block} must be a multiple of 4 dividing "
             f"the {n_k} cache rows")
    _require(tuple(k_cache.shape) == tuple(v_cache.shape) == (bh, n_k, d),
             "K/V caches must be [bh, n_k, d]")
    _require(block_indices.dtype == block_valid.dtype == cache_length.dtype
             == torch.int32, "index operands are int32")
    _check_cuda(q, k_cache, v_cache, block_indices, block_valid, cache_length)
    sm_scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    work, count, stream = _split_scratch(q, bh, g, d, budget)
    fn = _lib().decode_gather_attention
    _build.count_launch("decode_gather_attention")
    _build.check(fn(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(block_indices), _build.ptr(block_valid),
        _build.ptr(cache_length), _build.ptr(out), _build.ptr(work),
        _build.ptr(count), bh, g, d, key_block, budget, n_k // key_block,
        decode_split_slots(budget), float(sm_scale), ctypes.c_void_p(stream),
    ), "decode_gather_attention")
    return out

"""Paged MP-MRF decode kernels: B1 (filter) and B2 (survivor gather).

Each wrapper launches its CUDA kernel (``csrc/mpmrf_decode.cu``) when
its tensors lie on a CUDA device, and runs the plain PyTorch version
beside it when they lie on the CPU — the CPU tests' path. A CUDA tensor
never reaches the plain version through the wrapper; chip runs call the
plain functions directly to hold the kernels against them.

Ports of ``repro.kernels.mpmrf_decode.mpmrf_paged_filter_scores`` and
``paged_decode_gather_attention`` (the TPU Pallas kernels).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mpmrf_paged_filter_scores": [_P] * 8 + [_I] * 7 + [_P],
    "paged_decode_gather_attention": [_P] * 8 + [_I] * 6 + [_F, _P],
}
FILTER_HEAD_DIMS = (16, 32, 64, 128)


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


def paged_filter_scores_plain(
    q_plane, q_scale, k_codes_pages, k_page_scale, block_table,
    cache_length, *, round_bits=(2, 4), key_block=64,
):
    """Plain PyTorch version of B1 (bit-exact: integer dots in float64,
    which holds these small-integer sums exactly, and the reference's
    rescale association)."""
    lo, hi = round_bits
    bh, g, d = q_plane.shape
    bk = key_block
    mb = block_table.shape[-1]
    bt = block_table.long()
    codes = k_codes_pages[bt].to(torch.int32)                 # [bh, mb, bk, d]
    msb = codes >> (16 - lo)
    rem = (codes >> (16 - hi)) - (msb << (hi - lo))
    qp = q_plane.to(torch.float64)
    acc0 = torch.einsum("bgd,bjkd->bjgk", qp, msb.to(torch.float64))
    accr = torch.einsum("bgd,bjkd->bjgk", qp, rem.to(torch.float64))
    acc0 = acc0.round().to(torch.int32)
    acc1 = (acc0 << (hi - lo)) + accr.round().to(torch.int32)
    qs = (q_scale.float() * float(2 ** (16 - hi)))[:, None]   # [bh,1,g,1]
    ks = k_page_scale.float().reshape(-1)[bt][..., None, None]  # [bh,mb,1,1]
    s0 = (acc0.float() * qs) * (ks * float(2 ** (16 - lo)))
    s1 = (acc1.float() * qs) * (ks * float(2 ** (16 - hi)))
    kpos = (torch.arange(mb, device=qp.device)[:, None] * bk
            + torch.arange(bk, device=qp.device)[None, :])      # [mb, bk]
    ok = (kpos[None] < cache_length.long()[:, None, None])[:, :, None, :]
    s0 = torch.where(ok, s0, NEG_INF).amax(dim=(-2, -1))
    s1 = torch.where(ok, s1, NEG_INF).amax(dim=(-2, -1))
    return s0, s1


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


def paged_decode_gather_attention_plain(
    q, k_pages, v_pages, block_indices, block_valid, block_table,
    cache_length, *, key_block=64, scale=None,
):
    """Plain PyTorch version of B2: softmax over the gathered survivor
    keys with the kernel's masking rules (f32 math, output in V's
    dtype)."""
    bh, g, d = q.shape
    bk = key_block
    sm_scale = scale if scale is not None else 1.0 / (d ** 0.5)
    idx = block_indices.long()
    pages = torch.gather(block_table.long(), 1, idx)            # [bh, budget]
    k = k_pages[pages].float().reshape(bh, -1, d)               # [bh, S·bk, d]
    v = v_pages[pages].float().reshape(bh, -1, d)
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
    return out.to(v_pages.dtype)


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
    fn = _lib().paged_decode_gather_attention
    _build.count_launch("paged_decode_gather_attention")
    _build.check(fn(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(block_indices), _build.ptr(block_valid),
        _build.ptr(block_table), _build.ptr(cache_length), _build.ptr(out),
        bh, g, d, key_block, budget, mb, float(sm_scale),
        _build.stream_ptr(q.device),
    ), "paged_decode_gather_attention")
    return out

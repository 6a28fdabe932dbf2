"""MP-MRF Filtering Unit kernel: B9 (two-round block scores from
precomputed int8 planes).

CUDA tensors launch the kernel of ``csrc/mpmrf_filter.cu``; CPU tensors
run the plain PyTorch version beside it (the CPU tests' path).

Port of ``repro.kernels.mpmrf_filter.mpmrf_filter_scores`` (the TPU
Pallas kernel) and of its oracle ``repro.kernels.ref.mpmrf_filter_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mpmrf_decode import (
    NEG_INF, _check_cuda, _require, check_head_dim, check_plane_widths,
)
from repro_torch.kernels.flash_attention import row_chunk

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"mpmrf_filter_scores": [_P] * 6 + [_I] * 9 + [_P]}


def _lib():
    return _build.load("mpmrf_filter", _SIGNATURES)


# --------------------------------------------------------------------------
# the integer filter engine of B3 / B7 / B9 (csrc/filter_engine.cuh)
# --------------------------------------------------------------------------


def check_filter_launch(d, query_block, key_block, round_bits=None):
    """What the filter engine takes for B3 / B7 / B9: a head dim the
    kernels take (``mpmrf_decode.kernel_head_dim``), query blocks of
    16-row m-tiles up to 128 rows (at most eight warps), key blocks of
    8-key n-tiles up to 128 (the ring's shared memory) and, for B3 / B7,
    plane widths whose planes derive from the codes' high bytes
    (``check_plane_widths``). The decode kind's limits are
    ``mpmrf_decode.check_decode_filter_launch``."""
    check_head_dim(d)
    _require(query_block % 16 == 0 and 0 < query_block <= 128,
             f"query_block {query_block} must be a multiple of 16, <= 128")
    _require(key_block % 8 == 0 and 0 < key_block <= 128,
             f"key_block {key_block} must be a multiple of 8, <= 128")
    if round_bits is not None:
        check_plane_widths(round_bits)


def mpmrf_filter_scores_plain(
    q_plane, k_msb, k_rem, q_scale, *, query_block, key_block, shift,
    causal=True, q_offset=0,
):
    """Plain PyTorch version of B9 (bit-exact). The integer dots run as
    float32 matmuls: the planes are small integers (|q| ≤ 8, |msb| ≤ 2,
    rem ≤ 3), so every product and partial sum is an integer below
    2^24 and float32 holds it exactly in any summation order. Rows go
    through in chunks, so the ``[n_q, n_k]`` planes of a full-width
    call stay near a GiB."""
    bh, n_q, _ = q_plane.shape
    n_k = k_msb.shape[-2]
    bq, bk = query_block, key_block
    ok = None
    if causal:
        ok = (torch.arange(n_k, device=q_plane.device)[None, :]
              <= torch.arange(n_q, device=q_plane.device)[:, None]
              + q_offset)

    def rows(lo, hi):
        qf = q_plane[lo:hi].float()
        acc0 = torch.matmul(qf, k_msb[lo:hi].float().transpose(-1, -2))
        accr = torch.matmul(qf, k_rem[lo:hi].float().transpose(-1, -2))
        acc0, accr = acc0.to(torch.int32), accr.to(torch.int32)
        acc1 = acc0 * (1 << shift) + accr
        qs = q_scale[lo:hi].float()
        out = []
        for acc in (acc0, acc1):
            s = acc.float() * qs
            if ok is not None:
                s = torch.where(ok, s, NEG_INF)
            out.append(s.reshape(hi - lo, n_q // bq, bq, n_k // bk, bk)
                       .amax(dim=(2, 4)))
        return out

    step = row_chunk(n_q * n_k)
    parts = [rows(lo, min(lo + step, bh)) for lo in range(0, bh, step)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def mpmrf_filter_scores(
    q_plane: torch.Tensor,
    k_msb: torch.Tensor,
    k_rem: torch.Tensor,
    q_scale: torch.Tensor,
    *,
    shift: int,
    query_block: int = 128,
    key_block: int = 128,
    causal: bool = True,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused two-round block scores (B9).

    q_plane int8 ``[bh, n_q, d]`` (the final round's plane), k_msb /
    k_rem int8 ``[bh, n_k, d]``, q_scale f32 ``[bh, n_q, 1]``; ``shift``
    = round_bits[1] − round_bits[0]. Returns ``(s0, s1)`` f32
    ``[bh, n_qb, n_kb]``: per tile the max of ``acc·q_scale`` over the
    causally valid pairs (NEG_INF where there is none).
    """
    bh, n_q, d = q_plane.shape
    n_k = k_msb.shape[-2]
    _require(n_q % query_block == 0 and n_k % key_block == 0,
             f"{(n_q, n_k)} not divisible by {(query_block, key_block)}")
    if q_plane.device.type == "cpu":
        return mpmrf_filter_scores_plain(
            q_plane, k_msb, k_rem, q_scale, query_block=query_block,
            key_block=key_block, shift=shift, causal=causal,
            q_offset=q_offset,
        )
    _require(q_plane.is_cuda, f"unsupported device {q_plane.device}")
    _require(q_plane.dtype == k_msb.dtype == k_rem.dtype == torch.int8,
             "the CUDA filter kernel takes int8 planes")
    check_filter_launch(d, query_block, key_block)
    _require(0 <= shift <= 8, f"shift {shift} out of range")
    _require(tuple(k_msb.shape) == tuple(k_rem.shape) == (bh, n_k, d)
             and tuple(q_scale.shape) == (bh, n_q, 1),
             "planes / scale shapes disagree")
    q_scale = q_scale.float().contiguous()
    _check_cuda(q_plane, k_msb, k_rem, q_scale)
    n_qb, n_kb = n_q // query_block, n_k // key_block
    s0 = torch.empty((bh, n_qb, n_kb), dtype=torch.float32,
                     device=q_plane.device)
    s1 = torch.empty_like(s0)
    fn = _lib().mpmrf_filter_scores
    _build.count_launch("mpmrf_filter_scores")
    _build.check(fn(
        _build.ptr(q_plane), _build.ptr(k_msb), _build.ptr(k_rem),
        _build.ptr(q_scale), _build.ptr(s0), _build.ptr(s1),
        bh, n_q, n_k, d, query_block, key_block, shift, int(causal),
        int(q_offset), _build.stream_ptr(q_plane.device),
    ), "mpmrf_filter_scores")
    return s0, s1

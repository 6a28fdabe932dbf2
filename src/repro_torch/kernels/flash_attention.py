"""Dense flash attention kernel: B11 (the unpruned Attention Unit
baseline).

CUDA tensors launch the kernel of ``csrc/flash_attention.cu``; CPU
tensors run the plain PyTorch version beside it (the CPU tests' path).

Port of ``repro.kernels.flash_attention.flash_attention`` (the TPU
Pallas kernel) and of its oracle ``repro.kernels.ref.flash_attention_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mpmrf_decode import (
    NEG_INF, _check_cuda, _require, check_head_dim, kernel_head_dim,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention": [_P] * 4 + [_I] * 8 + [_F, _P]}
#: shared memory a block may use on the H100 (227 KB)
SMEM_LIMIT = 232448
#: keys per ring stage and stages of the tile engine (csrc/flash_common.cuh)
KEY_TILE, STAGES = 64, 3


def _lib():
    return _build.load("flash_attention", _SIGNATURES)


def row_chunk(per_row: int, budget: int = 1 << 28) -> int:
    """Rows a plain version handles at once so that its ``per_row``-
    element f32 intermediates stay near ``budget`` elements (1 GiB)."""
    return max(1, budget // max(per_row, 1))


def engine_smem_bytes(d: int, query_block: int, table_slots: int = 0) -> int:
    """Shared memory of one B10/B11 block at head dim ``d``, laid out for
    its instantiation D = ``kernel_head_dim(d)``: its bf16 Q/O stage (64
    rows on the wgmma path, D ≥ 64 and query blocks of 64 or 128, else
    the query block), a ring of STAGES K and V tiles of KEY_TILE rows,
    and (B10) the kept survivor list of ``table_slots`` ids and its
    count (``csrc/flash_common.cuh::smem_bytes``)."""
    check_head_dim(d)
    D = kernel_head_dim(d)
    rows = 64 if D >= 64 and query_block % 64 == 0 else query_block
    ring = 2 * D * (rows + 2 * STAGES * KEY_TILE)
    return ring + (4 * (table_slots + 1) if table_slots else 0)


def check_tile_engine(d, dtype, query_block, key_block,
                      table_slots=0) -> None:
    """What the tile engine's kernels (B4 / B8, B10, B11) take: bf16
    operands, a head dim the kernels take, one warp per 16 query rows
    (query_block ≤ 128), key blocks of multiples of 8 rows (the engine
    pads a partial tile with masked keys), and the engine's shared
    memory for ``table_slots`` kept survivor ids."""
    _require(dtype == torch.bfloat16,
             "the CUDA attention kernels take bfloat16 q/K/V")
    check_head_dim(d)
    _require(query_block % 16 == 0 and query_block <= 128,
             f"query_block {query_block} must be a multiple of 16, <= 128")
    _require(key_block % 8 == 0, "key_block must be a multiple of 8")
    smem = engine_smem_bytes(d, query_block, table_slots)
    _require(smem <= SMEM_LIMIT,
             f"the tile engine's {smem} bytes exceed shared memory")


def check_attention_launch(q, k, v, query_block, key_block,
                           table_slots=0, *, rows_of_q=True) -> None:
    """:func:`check_tile_engine` on CUDA operands of one dtype.
    ``rows_of_q``: K/V are ``[bh, n_k, d]`` beside q (B10, B11); the
    gathers check their own pool or cache layout."""
    d = q.shape[-1]
    _require(q.is_cuda, f"unsupported device {q.device}")
    _require(q.dtype == k.dtype == v.dtype, "q/K/V dtypes differ")
    check_tile_engine(d, q.dtype, query_block, key_block, table_slots)
    if rows_of_q:
        _require(k.shape == v.shape and k.shape[0] == q.shape[0]
                 and k.shape[-1] == d, "q/K/V shapes disagree")


def flash_attention_plain(q, k, v, *, causal=True, q_offset=0, scale=None):
    """Plain PyTorch version of B11: f32 scores and softmax with the
    kernel's rules (p = 0 wherever s ≤ NEG_INF/2, divide by
    max(l, 1e-30)), output in v's dtype. Rows go through in chunks."""
    bh, n_q, d = q.shape
    n_k = k.shape[-2]
    sm_scale = scale if scale is not None else 1.0 / (d ** 0.5)
    ok = None
    if causal:
        ok = (torch.arange(n_k, device=q.device)[None, :]
              <= torch.arange(n_q, device=q.device)[:, None] + q_offset)

    def rows(lo, hi):
        s = torch.matmul(q[lo:hi].float(),
                         k[lo:hi].float().transpose(-1, -2)) * sm_scale
        if ok is not None:
            s = torch.where(ok, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        return (torch.matmul(p, v[lo:hi].float()) / l).to(v.dtype)

    step = row_chunk(n_q * n_k)
    return torch.cat([rows(lo, min(lo + step, bh))
                      for lo in range(0, bh, step)])


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Dense flash attention (B11): q ``[bh, n_q, d]``, k/v
    ``[bh, n_k, d]`` → ``[bh, n_q, d]`` in v's dtype."""
    bh, n_q, d = q.shape
    n_k = k.shape[-2]
    _require(n_q % block_q == 0 and n_k % block_k == 0,
             f"{(n_q, n_k)} not divisible by {(block_q, block_k)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, scale=scale)
    check_attention_launch(q, k, v, block_q, block_k)
    _check_cuda(q, k, v)
    sm_scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    fn = _lib().flash_attention
    _build.count_launch("flash_attention")
    _build.check(fn(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        bh, n_q, n_k, d, block_q, block_k, int(causal), int(q_offset),
        float(sm_scale), _build.stream_ptr(q.device),
    ), "flash_attention")
    return out

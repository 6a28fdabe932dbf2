"""Block-sparse attention kernel: B10 (the Energon Attention Unit).

CUDA tensors launch the kernel of ``csrc/block_sparse_attention.cu``;
CPU tensors run the plain PyTorch version beside it (the CPU tests'
path).

Port of ``repro.kernels.block_sparse_attention.block_sparse_attention``
(the TPU Pallas kernel) and of its oracle
``repro.kernels.ref.block_sparse_attention_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check_attention_launch
from repro_torch.kernels.mpmrf_decode import NEG_INF, _check_cuda, _require

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"block_sparse_attention": [_P] * 6 + [_I] * 9 + [_F, _P]}


def _lib():
    return _build.load("block_sparse_attention", _SIGNATURES)


def block_sparse_attention_plain(
    q, k, v, block_indices, block_valid, *, query_block, key_block,
    causal=True, q_offset=0, scale=None,
):
    """Plain PyTorch version of B10: per query block, one softmax over
    its gathered survivor keys under the validity and causal masks (f32,
    the kernel's NEG_INF rules), output in v's dtype. Differentiable in
    q, k and v (the backward of ``ops.energon_block_attention``)."""
    bh, n_q, d = q.shape
    n_k = k.shape[-2]
    bq, bk = query_block, key_block
    n_qb = n_q // bq
    budget = block_indices.shape[-1]
    sm_scale = scale if scale is not None else 1.0 / (d ** 0.5)
    idx = block_indices.long()
    qb = q.float().reshape(bh, n_qb, bq, d)
    kb = k.float().reshape(bh, n_k // bk, bk, d)
    vb = v.float().reshape(bh, n_k // bk, bk, d)
    rows = torch.arange(bh, device=q.device)[:, None, None]
    kg = kb[rows, idx]                                  # [bh, n_qb, B, bk, d]
    vg = vb[rows, idx]
    s = torch.einsum("hiqd,hibkd->hiqbk", qb, kg) * sm_scale
    mask = (block_valid > 0)[:, :, None, :, None]
    if causal:
        qpos = (q_offset + torch.arange(n_qb, device=q.device)[:, None] * bq
                + torch.arange(bq, device=q.device)[None, :])  # [n_qb, bq]
        kpos = (idx[:, :, None, :, None] * bk
                + torch.arange(bk, device=q.device))       # [bh,n_qb,1,B,bk]
        mask = mask & (kpos <= qpos[None, :, :, None, None])
    s = torch.where(mask, s, NEG_INF)
    flat = s.reshape(bh, n_qb, bq, budget * bk)
    m = flat.amax(dim=-1, keepdim=True)
    p = torch.where(flat <= NEG_INF / 2, 0.0, torch.exp(flat - m))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    p = (p / l).reshape(s.shape)
    out = torch.einsum("hiqbk,hibkd->hiqd", p, vg)
    return out.reshape(bh, n_q, d).to(v.dtype)


def block_sparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_indices: torch.Tensor,
    block_valid: torch.Tensor,
    *,
    query_block: int = 128,
    key_block: int = 128,
    causal: bool = True,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of each query block over its survivor key blocks (B10).

    q ``[bh, n_q, d]``; k/v ``[bh, n_k, d]``; block_indices int32
    ``[bh, n_qb, B]`` survivor key-block ids in ``[0, n_kb)``;
    block_valid int32 ``[bh, n_qb, B]`` (1 = survivor, 0 = padded
    slot). Returns ``[bh, n_q, d]`` in v's dtype.
    """
    bh, n_q, d = q.shape
    n_k = k.shape[-2]
    _require(n_q % query_block == 0 and n_k % key_block == 0,
             f"{(n_q, n_k)} not divisible by {(query_block, key_block)}")
    if q.device.type == "cpu":
        return block_sparse_attention_plain(
            q, k, v, block_indices, block_valid, query_block=query_block,
            key_block=key_block, causal=causal, q_offset=q_offset,
            scale=scale,
        )
    n_qb = n_q // query_block
    budget = block_indices.shape[-1]
    check_attention_launch(q, k, v, query_block, key_block,
                           table_slots=budget)
    _require(tuple(block_indices.shape) == tuple(block_valid.shape)
             == (bh, n_qb, budget), "survivor table must be [bh, n_qb, B]")
    _require(block_indices.dtype == block_valid.dtype == torch.int32,
             "survivor table is int32")
    _check_cuda(q, k, v, block_indices, block_valid)
    sm_scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    fn = _lib().block_sparse_attention
    _build.count_launch("block_sparse_attention")
    _build.check(fn(
        _build.ptr(q), _build.ptr(k), _build.ptr(v),
        _build.ptr(block_indices), _build.ptr(block_valid), _build.ptr(out),
        bh, n_q, n_k, d, query_block, key_block, budget, int(causal),
        int(q_offset), float(sm_scale), _build.stream_ptr(q.device),
    ), "block_sparse_attention")
    return out

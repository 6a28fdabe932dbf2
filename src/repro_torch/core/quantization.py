"""Mixed-precision quantization for MP-MRF (port of
``repro.core.quantization``).

Q/K are quantized once to symmetric int16 and every lower-precision view
is the top ``bits`` bits of the same integer code (arithmetic right
shift), so ``code == (msb_plane << (16 - bits)) + lsb_remainder`` and
the rounds' dot products combine by shift-and-add (Fig. 7).

Scales are ``absmax · float32(1/32767)``: the reference's source
divides by 32767, but it runs under ``jax.jit`` wherever it is used, and
XLA folds that divide into a multiply by the float32 reciprocal. The
two differ by one ulp on some inputs, and one ulp in a scale can flip
an Eq. 3 threshold or a top-B tie, so the port multiplies as the
compiled reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

INT16_LEVELS = 32767  # symmetric int16 range [-32767, 32767]
#: float32(1 / 32767), the constant XLA multiplies by in place of the
#: reference's ``/ INT16_LEVELS``; float32 × float32 rounds once either
#: way, so a Python float holding it exactly gives the same product
INV_INT16_LEVELS = torch.tensor(1.0 / INT16_LEVELS, dtype=torch.float32).item()

Axes = Optional[Union[int, Tuple[int, ...]]]


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Int16 codes (stored as int32 for shifting) plus the float32
    dequantization scale, broadcastable to the codes."""

    codes: torch.Tensor
    scale: torch.Tensor
    axis: Axes = None

    @property
    def shape(self):
        return self.codes.shape

    def dequantize(self) -> torch.Tensor:
        return self.codes.float() * self.scale

    def bit_plane(self, bits: int) -> torch.Tensor:
        """Top ``bits`` bits of the int16 code (sign-keeping shift)."""
        if not 1 <= bits <= 16:
            raise ValueError(f"bits must be in [1,16], got {bits}")
        return self.codes >> (16 - bits)

    def plane_scale(self, bits: int) -> torch.Tensor:
        """Scale that dequantizes a ``bits``-bit plane to real units."""
        return self.scale * float(2 ** (16 - bits))

    def lsb_remainder(self, hi_bits: int, lo_bits: int) -> torch.Tensor:
        """The unsigned refinement plane between two plane widths:
        ``bit_plane(lo) == (bit_plane(hi) << (lo - hi)) + remainder``."""
        if not 1 <= hi_bits < lo_bits <= 16:
            raise ValueError(f"need 1 <= hi({hi_bits}) < lo({lo_bits}) <= 16")
        hi = self.bit_plane(hi_bits)
        lo = self.bit_plane(lo_bits)
        return lo - (hi << (lo_bits - hi_bits))


def quantize_int16(
    x: torch.Tensor, axis: Axes = -1, eps: float = 1e-8,
    absmax: Optional[torch.Tensor] = None,
) -> QuantizedTensor:
    """Symmetric int16 quantization with a per-slice absmax scale over
    ``axis`` (kept as size-1 dims; ``None`` → one per-tensor scale).
    ``absmax``: the slices' ``max |x|`` where ``x`` is a part of them (a
    cache split along the sequence: the whole cache's maxima)."""
    x = x.float()
    if absmax is None:
        absmax = (x.abs().amax() if axis is None
                  else x.abs().amax(dim=axis, keepdim=True))
    scale = torch.clamp(absmax, min=eps) * INV_INT16_LEVELS
    codes = torch.clamp(
        torch.round(x / scale), -INT16_LEVELS, INT16_LEVELS
    ).to(torch.int32)
    return QuantizedTensor(codes=codes, scale=scale, axis=axis)


def quantize_int16_blocks(
    x: torch.Tensor, block: int, eps: float = 1e-8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One absmax scale per ``block`` rows of ``x [..., n, d]``.

    Returns int16 codes ``[..., n, d]`` and float32 scales
    ``[..., n // block]``. A block's (codes, scale) depend only on its
    own rows, which is what lets a serving cache keep them resident and
    refresh only the block an append touched.
    """
    *lead, n, d = x.shape
    if n % block:
        raise ValueError(f"rows {n} not divisible by block {block}")
    xb = x.float().reshape(*lead, n // block, block, d)
    absmax = xb.abs().amax(dim=(-2, -1), keepdim=True)
    scale = torch.clamp(absmax, min=eps) * INV_INT16_LEVELS
    codes = torch.clamp(
        torch.round(xb / scale), -INT16_LEVELS, INT16_LEVELS
    ).to(torch.int16)
    return codes.reshape(*lead, n, d), scale[..., 0, 0]


def blockwise_quantized_view(
    codes: torch.Tensor, block_scales: torch.Tensor, block: int
) -> QuantizedTensor:
    """Resident block-quantized codes as a :class:`QuantizedTensor`
    whose per-row scale ``[..., n, 1]`` is the owning block's."""
    n = codes.shape[-2]
    if n % block or block_scales.shape[-1] != n // block:
        raise ValueError(
            f"codes rows {n} / block {block} mismatch scales "
            f"{tuple(block_scales.shape)}"
        )
    row_scale = torch.repeat_interleave(block_scales, block, dim=-1)[..., None]
    return QuantizedTensor(
        codes=codes.to(torch.int32), scale=row_scale, axis=(-2, -1)
    )


def _check_exact_f32_matmul(device) -> None:
    """The integer products below run as float32 matmuls, exact only at
    full float32 precision: TF32 keeps 10 mantissa bits and would round
    them silently. Raise rather than let it."""
    if torch.get_float32_matmul_precision() != "highest" or (
            device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "the MP-MRF integer products run as float32 matmuls and need "
            "full float32 precision, but TF32 is on "
            "(torch.set_float32_matmul_precision / "
            "torch.backends.cuda.matmul.allow_tf32)")


def plane_max(bits: int) -> int:
    """Largest magnitude of a ``bits``-bit plane (``code >> (16-bits)``)."""
    return 2 ** (bits - 1)


def int_qk_matmul(qp: torch.Tensor, kp: torch.Tensor,
                  max_abs: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Integer-domain ``qp @ kpᵀ`` with the reference's int32
    accumulators: qp ``[..., n_q, d]``, kp ``[..., n_k, d]`` integer
    planes → ``[..., n_q, n_k]`` int32.

    CUDA has no int32 matmul in torch, so the product runs in floating
    point where it is exact. ``max_abs`` bounds the operands' magnitudes;
    while ``d·max_q·max_k`` stays below 2^24 (planes of at most 8 bits
    with d ≤ 256) every partial sum is an integer that float32 holds in
    any summation order, else (or without a bound) float64 does, up to
    2^53. The result wraps to int32 as the reference's accumulators do.
    """
    d = qp.shape[-1]
    exact_f32 = max_abs is not None and d * max_abs[0] * max_abs[1] < 2 ** 24
    dtype = torch.float32 if exact_f32 else torch.float64
    if exact_f32:
        _check_exact_f32_matmul(qp.device)
    acc = torch.matmul(qp.to(dtype), kp.to(dtype).transpose(-1, -2))
    if exact_f32:                   # |acc| < 2^24: no wrap to mirror
        return acc.to(torch.int32)
    return acc.to(torch.int64).to(torch.int32)


def rescale_scores(
    acc: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor
) -> torch.Tensor:
    """Integer accumulators → real units, ``acc·q_scale·k_scale`` in the
    reference's association: ``q_scale`` keepdims ``[..., n_q, 1]``,
    ``k_scale`` keepdims ``[..., n_k, 1]`` (moved onto the key axis)."""
    if k_scale.dim() >= 2:
        k_scale = k_scale.transpose(-1, -2)
    return acc.float() * q_scale * k_scale


def low_bit_scores(q: QuantizedTensor, k: QuantizedTensor,
                   bits: int) -> torch.Tensor:
    """Approximate scores ``[..., n_q, n_k]`` f32 from the ``bits``-bit
    planes of ``q`` and ``k``: an exact integer product rescaled to real
    units. Above 8 bits the reference accumulates in float32 by design
    (int32 would overflow), and so does this."""
    qp, kp = q.bit_plane(bits), k.bit_plane(bits)
    if bits > 8:
        acc = torch.matmul(qp.float(), kp.float().transpose(-1, -2))
    else:
        acc = int_qk_matmul(qp, kp, (plane_max(bits),) * 2)
    return rescale_scores(acc, q.plane_scale(bits), k.plane_scale(bits))


def fake_quantize(x: torch.Tensor, bits: int, axis: Axes = -1
                  ) -> torch.Tensor:
    """Quantize → truncate to ``bits`` → dequantize, in float32."""
    qt = quantize_int16(x, axis=axis)
    return qt.bit_plane(bits).float() * qt.plane_scale(bits)

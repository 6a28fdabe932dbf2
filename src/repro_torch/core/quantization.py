"""Mixed-precision quantization for MP-MRF (port of
``repro.core.quantization``).

Q/K are quantized once to symmetric int16 and every lower-precision view
is the top ``bits`` bits of the same integer code (arithmetic right
shift), so ``code == (msb_plane << (16 - bits)) + lsb_remainder`` and
the rounds' dot products combine by shift-and-add (Fig. 7).

Scales are ``absmax / 32767`` computed with a true division, as the
reference's source states it. (Under ``jax.jit`` XLA folds the divide
into a multiply by ``1/32767``, which can move a scale by one ulp; the
codes agree either way on the tests' inputs.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

INT16_LEVELS = 32767  # symmetric int16 range [-32767, 32767]

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
    x: torch.Tensor, axis: Axes = -1, eps: float = 1e-8
) -> QuantizedTensor:
    """Symmetric int16 quantization with a per-slice absmax scale over
    ``axis`` (kept as size-1 dims; ``None`` → one per-tensor scale)."""
    x = x.float()
    if axis is None:
        absmax = x.abs().amax()
    else:
        absmax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(absmax, min=eps) / INT16_LEVELS
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
    scale = torch.clamp(absmax, min=eps) / INT16_LEVELS
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

"""Collectives over one mesh axis, on lists of per-device tensors.

The port drives a whole ``(pod, data, model)`` mesh from one controller
(:class:`repro_torch.launch.mesh.Mesh`), so a collective is a function
of the tensors its devices hold: a list in mesh order in, a list (or one
tensor) out. Each is a ``torch.autograd.Function`` whose backward is its
transpose, as XLA's are:

* :func:`all_gather` (concatenate the parts along a dim, one copy per
  target device) ↔ its backward, a reduce-scatter: the copies'
  gradients summed, each part given its slice;
* :func:`reduce_scatter` ↔ its backward, an all-gather;
* :func:`all_reduce` (the parts summed, held once) → its backward
  broadcasts the gradient to every part;
* :func:`broadcast` (one tensor, a copy per target) → its backward sums
  the copies' gradients (an all-reduce onto the source).

Every cross-device sum runs in f32, in list order, and rounds once to
the parts' dtype: what XLA's CPU collectives give on bf16 operands, and
the order :func:`repro_torch.models.moe.cross_shard_sum` fixed for the
serving mesh. A copy onto the device a tensor already lives on is a
view (no memory), so a mesh simulated on one card (``cuda:0`` × 4)
holds each gathered tensor once.

:func:`quantized_all_gather` is the reference's ``_quantized_all_gather``
(``repro.models.moe``): int8 codes with one scale per row of the
gathered axis on the wire, dequantized in the parts' dtype, and an exact
f32 reduce-scatter backward.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

_F32 = torch.float32


def _on(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: a view where it lives there, else a copy."""
    return x.view_as(x) if x.device == device else x.to(device)


def _sum_f32(grads: Sequence[Optional[torch.Tensor]], device: torch.device,
             dtype: torch.dtype) -> Optional[torch.Tensor]:
    """The present ``grads`` summed in f32 (f64 for f64) in list order on
    ``device``, rounded once to ``dtype`` (a lone gradient passes as it
    is); None where none is present."""
    present = [g for g in grads if g is not None]
    if not present:
        return None
    if len(present) == 1:
        return present[0].to(device=device, dtype=dtype)
    wide = torch.promote_types(dtype, _F32)       # f64 stays f64
    acc = present[0].to(device=device, dtype=wide)
    for g in present[1:]:
        acc = acc + g.to(device=device, dtype=wide)
    return acc.to(dtype)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim: int, devices, *parts):
        ctx.dim = dim
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.part_devices = [p.device for p in parts]
        ctx.dtype = parts[0].dtype
        whole = {}
        outs = []
        for dev in devices:
            if dev not in whole:
                whole[dev] = torch.cat([p.to(dev) for p in parts], dim=dim)
            outs.append(whole[dev].view_as(whole[dev]))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        dev = ctx.part_devices[0]
        total = _sum_f32(grads, dev, ctx.dtype)
        if total is None:
            return (None, None) + (None,) * len(ctx.sizes)
        pieces = total.split(ctx.sizes, dim=ctx.dim)
        return (None, None) + tuple(
            p.to(d) for p, d in zip(pieces, ctx.part_devices))


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The parts (one per device of an axis, in order) concatenated
    along ``dim``, one copy on each of ``devices``. Backward: the
    copies' gradients summed in f32 in order, rounded once, each part
    given its slice (a reduce-scatter)."""
    return list(_AllGather.apply(dim, tuple(devices), *parts))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim: int, *parts):
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        n = len(parts)
        total = _sum_f32(parts, parts[0].device, parts[0].dtype)
        ctx.size = total.shape[dim] // n
        return tuple(c.to(d) for c, d in zip(total.split(ctx.size, dim=dim),
                                             ctx.devices))

    @staticmethod
    def backward(ctx, *grads):
        ref = next((g for g in grads if g is not None), None)
        if ref is None:
            return (None,) * (1 + len(ctx.devices))
        dev = ctx.devices[0]
        whole = torch.cat([torch.zeros_like(ref, device=dev) if g is None
                           else g.to(dev) for g in grads], dim=ctx.dim)
        return (None,) + tuple(_on(whole, d) for d in ctx.devices)


def reduce_scatter(parts: Sequence[torch.Tensor], dim: int
                   ) -> List[torch.Tensor]:
    """The parts (same shape, one per device) summed in f32 in order,
    rounded once, and split along ``dim`` into as many slices, slice i
    on part i's device. Backward: an all-gather of the slices'
    gradients onto every part."""
    return list(_ReduceScatter.apply(dim, *parts))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, device, *parts):
        ctx.devices = [p.device for p in parts]
        return _sum_f32(parts, device, parts[0].dtype)

    @staticmethod
    def backward(ctx, grad):
        return (None,) + tuple(grad.to(d) for d in ctx.devices)


def all_reduce(parts: Sequence[torch.Tensor],
               device: Optional[torch.device] = None) -> torch.Tensor:
    """The parts summed in f32 in order and rounded once to their dtype,
    held once on ``device`` (default the first part's): the replicated
    result, which the controller keeps a single copy of. Backward: the
    gradient broadcast to every part."""
    device = parts[0].device if device is None else device
    return _AllReduce.apply(device, *parts)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, x):
        ctx.device, ctx.dtype = x.device, x.dtype
        return tuple(_on(x, d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        return None, _sum_f32(grads, ctx.device, ctx.dtype)


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]
              ) -> List[torch.Tensor]:
    """``x`` on each of ``devices`` (a view where it already lives
    there). Backward: the copies' gradients summed in f32 in order,
    rounded once (an all-reduce onto the source)."""
    return list(_Broadcast.apply(tuple(devices), x))


# --------------------------------------------------------------------------
# int8 weight gather (the reference's _quantized_all_gather)
# --------------------------------------------------------------------------


def quantize_rows(w: torch.Tensor, dim: int):
    """``(codes int8, scale)`` of one part: one scale per row of ``dim``
    (``max |w|`` over ``dim``, kept as a size-1 dim, over 127, at least
    1e-12), codes ``clip(round(w / scale), ±127)`` — the reference's
    lines op for op, in ``w``'s dtype."""
    scale = torch.clamp(w.abs().amax(dim=dim, keepdim=True) / 127.0,
                        min=1e-12)
    codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return codes, scale


class _QuantizedAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim: int, devices, *parts):
        ctx.dim = dim
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.part_devices = [p.device for p in parts]
        ctx.dtype = parts[0].dtype
        quant = [quantize_rows(p, dim) for p in parts]
        whole = {}
        outs = []
        for dev in devices:
            if dev not in whole:
                codes = torch.cat([c.to(dev) for c, _ in quant], dim=dim)
                scales = torch.cat([
                    s.to(dev).repeat_interleave(n, dim=dim)
                    for (_, s), n in zip(quant, ctx.sizes)], dim=dim)
                whole[dev] = codes.to(ctx.dtype) * scales.to(ctx.dtype)
            outs.append(whole[dev].view_as(whole[dev]))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        # the exact cotangent: this part's slice of the gathered weight's
        # gradient, reduced in f32 (the reference's psum_scatter of
        # g.astype(float32), cast back)
        total = _sum_f32(grads, ctx.part_devices[0], ctx.dtype)
        if total is None:
            return (None, None) + (None,) * len(ctx.sizes)
        pieces = total.split(ctx.sizes, dim=ctx.dim)
        return (None, None) + tuple(
            p.to(d) for p, d in zip(pieces, ctx.part_devices))


def quantized_all_gather(parts: Sequence[torch.Tensor], dim: int,
                         devices: Sequence[torch.device]
                         ) -> List[torch.Tensor]:
    """:func:`all_gather` with int8 codes on the wire: each part sends
    :func:`quantize_rows` codes and scales over ``dim``, each copy is
    ``codes · scale`` in the parts' dtype. Backward: the exact f32
    reduce-scatter of :func:`all_gather`."""
    return list(_QuantizedAllGather.apply(dim, tuple(devices), *parts))

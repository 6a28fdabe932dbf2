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

Each takes ``axes`` (required), the mesh axes it runs over ('data',
'model', …): the price is recorded under them.

**Priced.** While an op-cost walk runs (:mod:`repro_torch.analysis.
op_costs` sets :data:`price_hook`), every collective reports what its
XLA counterpart would count, by ``repro.analysis.hlo_costs``' rule: its
operands' bytes on each device it runs on, under the reference's type
names (``all-gather``, ``reduce-scatter``, ``all-reduce``) and the axes
it runs over; the ops it runs to do so are not priced again. A
:func:`broadcast` is free — in SPMD every target already holds the
value (a replicated activation, a weight replicated over 'data') — and
its backward is the all-reduce of the gradients. A collective of one
part onto one device is no collective and costs nothing.

**A share** (a ``Mesh.share``): the one-controller program runs one
device's share of the mesh, and a collective it calls holds that
device's part alone. The caller says so with ``share=(n, k)`` — the
axes' size and the device's index along them, from :func:`share_of`
(the share's mesh) or :func:`shards_share` (a share's model-axis
:class:`Shards`) —, and the collective returns that device's output:
its true shape and dtype, with stand-in values (the local part in
every position of a gather, the local partial as a sum): on the card a
share's outputs are shapes, not the mesh step's values. Its price is
that device's operand bytes; its backward is priced likewise and hands
the local part its slice of the gradient. :class:`Shards` carries a
model-axis leaf's logical shard indices, so a share's one shard keeps
its index ``m``.

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

from typing import Callable, List, Optional, Sequence, Tuple

import torch

_F32 = torch.float32

#: set by an op-cost walk while it runs: ``price_hook(kind, axes, nbytes,
#: traffic, fn)`` runs ``fn()`` with its ops unpriced, records
#: ``nbytes`` under ``kind`` and ``axes`` and ``traffic`` as HBM bytes,
#: and returns ``fn()``'s result
price_hook: Optional[Callable] = None

#: a share's place along a collective's axes: (their size, its index)
Share = Optional[Tuple[int, int]]


def share_of(mesh, axes) -> Share:
    """``(n, k)`` for a share (``mesh.coord`` set): the size of ``axes``
    and the share's index along them (row-major). None for a whole mesh,
    no mesh, or axes of size 1 (where the collective is no collective)."""
    if mesh is None or mesh.coord is None:
        return None
    n, k = 1, 0
    for a in axes:
        n *= mesh.shape[a]
        k = k * mesh.shape[a] + mesh.coord[a]
    return (n, k) if n > 1 else None


class Shards(tuple):
    """A mesh row's model-axis shards of one leaf or activation: shard
    ``start + i`` of ``total`` at position i. A whole row holds all
    (``start`` 0); a share holds its own one."""

    def __new__(cls, items, start: int = 0, total: Optional[int] = None):
        out = super().__new__(cls, items)
        out.start = start
        out.total = len(out) if total is None else total
        return out


def shard_start(shards) -> int:
    """The logical index of ``shards``' first entry (0 for a tuple)."""
    return getattr(shards, "start", 0)


def shard_total(shards) -> int:
    """How many shards the model axis holds (``len`` of a tuple)."""
    return getattr(shards, "total", len(shards))


def shards_share(shards) -> Share:
    """``(n, k)`` where ``shards`` hold fewer than the model axis's
    ``n`` — a share's one shard, logical index ``k`` —, else None."""
    n = shard_total(shards)
    return None if len(shards) == n else (n, shard_start(shards))


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _priced(kind: str, axes, nbytes: float, traffic: float, fn):
    """``fn()`` under the walk's hook, if one runs: its ops unpriced, and
    ``nbytes`` / ``traffic`` recorded (nothing for a trivial collective,
    ``nbytes`` 0)."""
    if price_hook is None:
        return fn()
    if nbytes == 0:
        traffic = 0
    return price_hook(kind, tuple(axes), float(nbytes), float(traffic), fn)


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


def _grad_bytes(grads) -> int:
    return sum(_nbytes(g) for g in grads)


def _share_parts(parts, share: Share):
    """A share's local part in each of its axes' ``n`` positions, and its
    index; else ``parts`` as they are and None."""
    if share is None:
        return tuple(parts), None
    n, k = share
    return (parts[0],) * n, k


def _scatter_back(ctx, grads, kind: str, nbytes: int):
    """A gather's backward, priced as ``kind``: the copies' gradients
    summed in f32 in order, each part given its slice — a share's part
    alone (its index ``ctx.k``), in a buffer of its own, as a
    reduce-scatter's output is."""
    present = [g for g in grads if g is not None]
    if not present:
        return (None,) * len(ctx.sizes)

    def run():
        total = _sum_f32(grads, ctx.part_devices[0], ctx.dtype)
        pieces = total.split(ctx.sizes, dim=ctx.dim)
        if ctx.k is not None:
            return tuple(p.to(d, copy=True) if i == ctx.k else None
                         for i, (p, d) in enumerate(zip(pieces,
                                                        ctx.part_devices)))
        return tuple(p.to(d) for p, d in zip(pieces, ctx.part_devices))

    out = _nbytes(present[0])
    if ctx.k is not None:
        out //= len(ctx.sizes)
    return _priced(kind, ctx.axes, nbytes, nbytes + out, run)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim: int, devices, axes, k, *parts):
        ctx.dim, ctx.axes, ctx.k = dim, axes, k
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.part_devices = [p.device for p in parts]
        ctx.dtype = parts[0].dtype
        trivial = len(parts) == 1 and len(devices) == 1
        part = sum(_nbytes(p) for p in parts) // len(parts)
        whole_bytes = sum(_nbytes(p) for p in parts)

        def run():
            whole = {}
            outs = []
            for dev in devices:
                if dev not in whole:
                    whole[dev] = torch.cat([p.to(dev) for p in parts],
                                           dim=dim)
                outs.append(whole[dev].view_as(whole[dev]))
            return tuple(outs)

        n = len(devices)
        return _priced("all-gather", axes, 0 if trivial else n * part,
                       n * (part + whole_bytes), run)

    @staticmethod
    def backward(ctx, *grads):
        trivial = len(ctx.sizes) == 1 and len(grads) == 1
        nbytes = 0 if trivial else _grad_bytes(grads)
        return (None,) * 4 + _scatter_back(ctx, grads, "reduce-scatter",
                                           nbytes)


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               devices: Sequence[torch.device], *, axes,
               share: Share = None) -> List[torch.Tensor]:
    """The parts (one per device of ``axes``, in order) concatenated
    along ``dim``, one copy on each of ``devices``. Backward: the
    copies' gradients summed in f32 in order, rounded once, each part
    given its slice (a reduce-scatter). ``share``: ``parts`` is the
    share's local part alone."""
    parts, k = _share_parts(parts, share)
    return list(_AllGather.apply(dim, tuple(devices), tuple(axes), k,
                                 *parts))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim: int, axes, *parts):
        ctx.dim, ctx.axes = dim, axes
        ctx.devices = [p.device for p in parts]
        n = len(parts)
        nbytes = 0 if n == 1 else sum(_nbytes(p) for p in parts)

        def run():
            total = _sum_f32(parts, parts[0].device, parts[0].dtype)
            ctx.size = total.shape[dim] // n
            return tuple(c.to(d) for c, d in
                         zip(total.split(ctx.size, dim=dim), ctx.devices))

        return _priced("reduce-scatter", axes, nbytes,
                       nbytes + _nbytes(parts[0]), run)

    @staticmethod
    def backward(ctx, *grads):
        ref = next((g for g in grads if g is not None), None)
        if ref is None:
            return (None,) * (2 + len(ctx.devices))
        dev = ctx.devices[0]
        n = len(ctx.devices)

        def run():
            whole = torch.cat([torch.zeros_like(ref, device=dev) if g is None
                               else g.to(dev) for g in grads], dim=ctx.dim)
            return tuple(_on(whole, d) for d in ctx.devices)

        nbytes = 0 if n == 1 else n * _nbytes(ref)
        return (None, None) + _priced("all-gather", ctx.axes, nbytes,
                                      nbytes + n * n * _nbytes(ref), run)


def reduce_scatter(parts: Sequence[torch.Tensor], dim: int, *, axes
                   ) -> List[torch.Tensor]:
    """The parts (same shape, one per device) summed in f32 in order,
    rounded once, and split along ``dim`` into as many slices, slice i
    on part i's device. Backward: an all-gather of the slices'
    gradients onto every part. (No program of the port runs one in a
    share: a gather's backward is its reduce-scatter there.)"""
    return list(_ReduceScatter.apply(dim, tuple(axes), *parts))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, device, axes, share: bool, *parts):
        ctx.devices = [p.device for p in parts]
        n = len(parts)
        if share:       # one device's partial: a stand-in of the sum
            nbytes = _nbytes(parts[0])
            return _priced("all-reduce", axes, nbytes, 2 * nbytes,
                           lambda: parts[0].to(device=device, copy=True))
        nbytes = 0 if n == 1 else sum(_nbytes(p) for p in parts)
        return _priced("all-reduce", axes, nbytes,
                       nbytes + n * _nbytes(parts[0]),
                       lambda: _sum_f32(parts, device, parts[0].dtype))

    @staticmethod
    def backward(ctx, grad):
        return (None,) * 3 + tuple(grad.to(d) for d in ctx.devices)


def all_reduce(parts: Sequence[torch.Tensor],
               device: Optional[torch.device] = None, *, axes,
               share: Share = None) -> torch.Tensor:
    """The parts summed in f32 in order and rounded once to their dtype,
    held once on ``device`` (default the first part's): the replicated
    result, which the controller keeps a single copy of. Backward: the
    gradient broadcast to every part. ``share``: the share's local
    partial alone, priced as its device's all-reduce over ``axes``."""
    device = parts[0].device if device is None else device
    return _AllReduce.apply(device, tuple(axes), share is not None, *parts)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, axes, share: bool, x):
        ctx.device, ctx.dtype, ctx.axes = x.device, x.dtype, axes
        ctx.share = share
        return tuple(_on(x, d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        present = [g for g in grads if g is not None]
        if ctx.share and present:   # the device's own gradient, summed:
            nbytes = _nbytes(present[0])        # a stand-in of its own

            def run():
                return present[0].to(ctx.device, ctx.dtype, copy=True)
        else:
            nbytes = 0 if len(present) <= 1 else _grad_bytes(present)

            def run():
                return _sum_f32(grads, ctx.device, ctx.dtype)
        out = _priced("all-reduce", ctx.axes, nbytes,
                      nbytes + _nbytes(present[0] if present else None), run)
        return None, None, None, out


def broadcast(x: torch.Tensor, devices: Sequence[torch.device], *, axes,
              share: Share = None) -> List[torch.Tensor]:
    """``x`` on each of ``devices`` (a view where it already lives
    there): free. Backward: the copies' gradients summed in f32 in
    order, rounded once (an all-reduce over ``axes`` onto the source;
    ``share``: the share's one copy, priced as its device's)."""
    return list(_Broadcast.apply(tuple(devices), tuple(axes),
                                 share is not None, x))


class _Slices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim: int, bounds, devices, axes, x):
        ctx.dim, ctx.bounds, ctx.axes = dim, bounds, axes
        ctx.device, ctx.dtype, ctx.shape = x.device, x.dtype, x.shape
        ctx.nbytes = _nbytes(x)
        return tuple(_on(x.narrow(dim, lo, n), d)
                     for (lo, n), d in zip(bounds, devices))

    @staticmethod
    def backward(ctx, *grads):
        present = [(b, g) for b, g in zip(ctx.bounds, grads)
                   if g is not None]
        if not present:
            return (None,) * 5

        def run():
            wide = torch.promote_types(ctx.dtype, _F32)
            out = torch.zeros(ctx.shape, dtype=wide, device=ctx.device)
            for (lo, n), g in present:
                out.narrow(ctx.dim, lo, n).add_(g.to(ctx.device, wide))
            return out.to(ctx.dtype)

        nbytes = _grad_bytes([g for _, g in present])
        return (None,) * 4 + (_priced("all-gather", ctx.axes, nbytes,
                                      nbytes + ctx.nbytes, run),)


def slices(x: torch.Tensor, dim: int, bounds: Sequence[Tuple[int, int]],
           devices: Sequence[torch.device], *, axes) -> List[torch.Tensor]:
    """Each device's slice ``(start, length)`` along ``dim`` of ``x``, a
    leaf replicated over ``axes`` (every device holds it, so the slice
    is free; a view where the device is x's). Backward: the slices'
    gradients placed back at their offsets, overlaps summed in f32 in
    order and rounded once — priced as the all-gather of the slices'
    gradients over ``axes`` that GSPMD gives a replicated leaf whose
    use is split (operand bytes: each slice's gradient on its device; a
    share passes its one slice)."""
    return list(_Slices.apply(dim, tuple(bounds), tuple(devices),
                              tuple(axes), x))


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


def _wire_bytes(part: torch.Tensor, dim: int) -> int:
    """One part's int8 codes and scales on the wire."""
    return part.numel() + _nbytes(part) // max(part.shape[dim], 1)


class _QuantizedAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim: int, devices, axes, k, *parts):
        ctx.dim, ctx.axes, ctx.k = dim, axes, k
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.part_devices = [p.device for p in parts]
        ctx.dtype = parts[0].dtype

        def run():
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

        n = len(devices)
        wire = _wire_bytes(parts[0], dim)
        trivial = len(parts) == 1 and n == 1
        return _priced("all-gather", axes, 0 if trivial else n * wire,
                       n * (wire + sum(_nbytes(p) for p in parts)), run)

    @staticmethod
    def backward(ctx, *grads):
        # the exact cotangent: this part's slice of the gathered weight's
        # gradient, reduced in f32 (the reference's psum_scatter of
        # g.astype(float32), cast back)
        trivial = len(ctx.sizes) == 1 and len(grads) == 1
        nbytes = 0 if trivial else sum(g.numel() * 4 for g in grads
                                       if g is not None)
        return (None,) * 4 + _scatter_back(ctx, grads, "reduce-scatter",
                                           nbytes)


def quantized_all_gather(parts: Sequence[torch.Tensor], dim: int,
                         devices: Sequence[torch.device], *, axes,
                         share: Share = None) -> List[torch.Tensor]:
    """:func:`all_gather` with int8 codes on the wire: each part sends
    :func:`quantize_rows` codes and scales over ``dim``, each copy is
    ``codes · scale`` in the parts' dtype. Backward: the exact f32
    reduce-scatter of :func:`all_gather`. ``share`` as there."""
    parts, k = _share_parts(parts, share)
    return list(_QuantizedAllGather.apply(dim, tuple(devices), tuple(axes),
                                          k, *parts))

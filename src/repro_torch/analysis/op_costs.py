"""Structural cost of one call of the port's eager program (the port's
counterpart of ``repro.analysis.hlo_costs``).

The reference parses the compiled, fused HLO of a jitted step. The port
runs eagerly, one kernel per ATen op, so :func:`compute_costs` walks one
call under a ``TorchDispatchMode`` and prices every op as it runs:

* **FLOPs** — every matmul-class op (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``mv``, ``addmv``, ``dot``, ``convolution``) by the
  reference's ``_dot_flops`` rule: 2 × output elements × contracted size.
* **Traffic** — each op's tensor operands' bytes plus its outputs' bytes
  (an in-place op reads and writes its target). Views and bare
  allocations (``empty*``) launch nothing and move nothing. Each eager
  op is its own kernel, so this is the unfused traffic.
* **Collectives** — each call of :mod:`repro_torch.distributed.
  collectives` priced as its XLA counterpart (``hlo_costs``' rule: the
  operands' bytes on every device it runs on) under the reference's
  type names (``all-gather``, ``reduce-scatter``, ``all-reduce``) in
  ``collective_bytes`` and by the mesh axes it runs over in
  ``collective_bytes_by_axis``; its operand and output bytes join the
  traffic, as the reference's parser adds them, and the ops it runs are
  not priced again (their outputs' storages count toward the peak). A
  share's collectives (``Mesh.share``) price the walked device alone.
  ``"copy"`` keeps the copies between two distinct non-CPU devices made
  outside a collective; a host upload is traffic, not a collective.
* **Kernels** — each launch of B1–B11 is priced once from its shapes
  (``repro_torch.analysis.kernel_traffic``'s shape-only mode: its bytes
  into the traffic, its operations into the FLOPs), and no op of the
  wrapper or of its plain version is counted. ``kernels/ops.py`` hands
  every kernel call to ``_build.cost_hook``, which this walk alone sets:
  on the card the CUDA launch is invisible to a dispatch mode, on the
  CPU the wrapper runs its plain version, and on the meta device the
  walk runs the plain version itself (shapes only; outside a walk a
  wrapper refuses a meta tensor). The walk's launches per kernel equal
  what ``_build.launch_counts`` counts for the same call on the card.
* **``peak_live_bytes``** — the peak, over the call, of the live bytes
  of the storages the call created: each storage once (views share
  it), rounded up to the CUDA caching allocator's 512-byte blocks,
  gone when its last reference dies (an autograd graph's saved tensors
  included); in-place ops add nothing, and neither do the storages that
  existed before the call (its arguments). A kernel's outputs count
  from its launch; its plain version's temporaries never do. An op's
  own temporaries are allocated below the dispatch mode and unseen,
  except where ``_HIDDEN_TEMPS`` models them (``logsumexp``).

The same walk runs on ``cpu``, ``cuda`` and ``meta`` tensors, and gives
the same FLOPs, traffic and launches on each wherever the program
dispatches the same ops. There is no counterpart of the reference's
``costs_from_compiled`` or of its HLO-text helpers (``shape_bytes``,
``parse_hlo``): the port has no compiled module to read.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import kernel_traffic as kt
from repro_torch.distributed import collectives as col
from repro_torch.kernels import _build

#: the CUDA caching allocator's block size: every allocation rounds up
ALLOC_BLOCK = 512

_aten = torch.ops.aten
_NO_KERNEL = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default,
}


@dataclasses.dataclass
class KernelCost:
    """One kernel's launches in a walk and their shape-only price."""

    launches: int = 0
    bytes: int = 0
    ops: int = 0
    bound_ms: float = 0.0


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    collective_ops: List[Tuple[str, str, float, float]] = dataclasses.field(
        default_factory=list
    )  # (kind, op or axes, bytes, multiplier)
    #: collective bytes by the mesh axes they run over (``"data"``,
    #: ``"model"``, ``"pod+data"``, …)
    collective_bytes_by_axis: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    peak_live_bytes: int = 0
    #: bytes of the result's tensor leaves whose storages the call made
    output_bytes: int = 0
    #: B1–B11 by their ``_build.launch_counts`` name
    kernels: Dict[str, KernelCost] = dataclasses.field(default_factory=dict)
    #: FLOPs by ATen op (the kernels' operations under their names)
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: traffic bytes by ATen op (the kernels' under their names)
    traffic_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: ops priced (views, bare allocations and kernel internals excluded)
    num_ops: int = 0
    seconds: float = 0.0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def launches(self) -> Dict[str, int]:
        return {name: k.launches for name, k in self.kernels.items()}


# ---------------------------------------------------------------------------
# per-op rules
# ---------------------------------------------------------------------------


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rounded(nbytes: int) -> int:
    """An allocation's bytes as the caching allocator's blocks count them."""
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


def _conv_flops(args, out) -> float:
    """A convolution's multiply-adds: each output element contracts
    C_in / groups channels × the kernel's taps (a transposed one: each
    input element feeds C_out / groups channels × the taps)."""
    x, w = args[0], args[1]
    taps = _numel(w.shape[2:])
    if len(args) > 6 and args[6]:          # transposed: w [C_in, C_out/g, *k]
        return 2.0 * x.numel() * w.shape[1] * taps
    return 2.0 * out.numel() * w.shape[1] * taps


#: 2 × output elements × contracted size, by op
_DOT_RULES: Dict[Any, Callable] = {
    _aten.mm.default: lambda a, o: 2.0 * o.numel() * a[0].shape[-1],
    _aten.addmm.default: lambda a, o: 2.0 * o.numel() * a[1].shape[-1],
    _aten.bmm.default: lambda a, o: 2.0 * o.numel() * a[0].shape[-1],
    _aten.baddbmm.default: lambda a, o: 2.0 * o.numel() * a[1].shape[-1],
    _aten.mv.default: lambda a, o: 2.0 * o.numel() * a[0].shape[-1],
    _aten.addmv.default: lambda a, o: 2.0 * o.numel() * a[1].shape[-1],
    _aten.dot.default: lambda a, o: 2.0 * a[0].numel(),
    _aten.convolution.default: _conv_flops,
}


#: ops whose ATen implementation allocates a temporary through the
#: dispatcher below the walk (a dispatch mode sees the op, not the
#: calls inside it): its bytes, alive while the op runs. ``logsumexp``
#: subtracts the row max into a tensor the size of its input
#: (``logsumexp_out_impl``, on every device), which sets the peak of an
#: f32 cross-entropy over a large vocabulary.
_HIDDEN_TEMPS: Dict[Any, Callable] = {
    _aten.logsumexp.default: lambda a: _nbytes(a[0]),
}


@dataclasses.dataclass(frozen=True)
class _OpInfo:
    """What the walk needs of one ATen overload, looked up once."""

    #: per return: a new tensor (no alias annotation), not a view or an
    #: in-place / ``out=`` result
    fresh: Tuple[bool, ...]
    #: launches no kernel: a view, or a bare allocation
    free: bool
    rule: Any
    hidden: Any


_INFO: Dict[Any, _OpInfo] = {}


def _info(func) -> _OpInfo:
    info = _INFO.get(func)
    if info is None:
        returns = func._schema.returns
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in returns)
        info = _INFO[func] = _OpInfo(
            fresh=tuple(r.alias_info is None for r in returns),
            free=view or func in _NO_KERNEL, rule=_DOT_RULES.get(func),
            hidden=_HIDDEN_TEMPS.get(func))
    return info


def _tensors(args, kwargs) -> List[torch.Tensor]:
    """The tensors among an ATen call's arguments (top level, or in a
    list or tuple argument, as ATen schemas put them)."""
    out = []
    for x in (*args, *kwargs.values()):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


# ---------------------------------------------------------------------------
# the kernels' shape-only prices, from the wrapper's bound arguments
# ---------------------------------------------------------------------------


def _b1(a):
    bh, g, d = a["q_plane"].shape
    return kt.decode_filter(bh, g, d, a["key_block"],
                            a["block_table"].shape[-1], paged=True)


def _b2(a):
    bh, g, d = a["q"].shape
    return kt.decode_gather(bh, g, d, a["key_block"],
                            a["block_indices"].shape[-1], paged=True,
                            itemsize=a["q"].element_size())


def _b3(a):
    bh, n_q, d = a["q_plane"].shape
    return kt.prefill_filter(bh, n_q, d, a["query_block"], a["key_block"],
                             a["block_table"].shape[-1], paged=True)


def _b4(a):
    bh, n_q, d = a["q"].shape
    return kt.prefill_gather(bh, n_q, d, a["query_block"], a["key_block"],
                             a["block_indices"].shape[-1],
                             itemsize=a["q"].element_size())


def _b5(a):
    bh, g, d = a["q_plane"].shape
    return kt.decode_filter(bh, g, d, a["key_block"],
                            a["k_codes"].shape[1] // a["key_block"],
                            paged=False)


def _b6(a):
    bh, g, d = a["q"].shape
    return kt.decode_gather(bh, g, d, a["key_block"],
                            a["block_indices"].shape[-1], paged=False,
                            itemsize=a["q"].element_size())


def _b7(a):
    bh, n_q, d = a["q_plane"].shape
    return kt.prefill_filter(bh, n_q, d, a["query_block"], a["key_block"],
                             a["k_codes"].shape[1] // a["key_block"],
                             paged=False)


def _b9(a):
    bh, n_q, d = a["q_plane"].shape
    return kt.sequence_filter(bh, n_q, a["k_msb"].shape[1], d,
                              a["query_block"], a["key_block"],
                              causal=a["causal"], q_offset=a["q_offset"])


def _b10(a):
    bh, n_q, d = a["q"].shape
    return kt.block_sparse(bh, n_q, d, a["query_block"], a["key_block"],
                           a["block_indices"].shape[-1],
                           itemsize=a["q"].element_size())


def _b11(a):
    bh, n_q, d = a["q"].shape
    return kt.flash(bh, n_q, a["k"].shape[1], d, causal=a["causal"],
                    q_offset=a["q_offset"], itemsize=a["q"].element_size())


#: ``_build.launch_counts`` name → shape-only price of one launch
PRICES: Dict[str, Callable] = {
    "mpmrf_paged_filter_scores": _b1,
    "paged_decode_gather_attention": _b2,
    "mpmrf_paged_prefill_filter_scores": _b3,
    "paged_prefill_gather_attention": _b4,
    "mpmrf_decode_filter_scores": _b5,
    "decode_gather_attention": _b6,
    "mpmrf_prefill_filter_scores": _b7,
    "prefill_gather_attention": _b4,       # B8: B4's geometry, unpaged
    "mpmrf_filter_scores": _b9,
    "block_sparse_attention": _b10,
    "flash_attention": _b11,
}


def _plain(kernel: Callable) -> Callable:
    """A wrapper's plain PyTorch version (``<wrapper>_plain`` beside it)."""
    return getattr(inspect.getmodule(kernel), kernel.__name__ + "_plain")


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


class _Walk(TorchDispatchMode):

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.live = 0
        self.inside = 0                       # > 0 inside a kernel's call
        self._mine: Dict[int, weakref.finalize] = {}
        self._foreign: Dict[int, weakref.finalize] = {}

    # --- storages ---------------------------------------------------------

    def _gone(self, key, nbytes):
        self._mine.pop(key, None)
        self.live -= nbytes

    def _note_foreign(self, tensors) -> None:
        for t in tensors:
            s = t.untyped_storage()
            key = s._cdata
            if key not in self._mine and key not in self._foreign:
                self._foreign[key] = weakref.finalize(
                    s, self._foreign.pop, key, None)

    def _note_new(self, tensors) -> None:
        for t in tensors:
            s = t.untyped_storage()
            key = s._cdata
            if key in self._mine or key in self._foreign:
                continue
            n = _rounded(s.nbytes())
            self.live += n
            self._mine[key] = weakref.finalize(s, self._gone, key, n)
        if self.live > self.costs.peak_live_bytes:
            self.costs.peak_live_bytes = self.live

    # --- ops --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.inside:
            return out
        info = _info(func)
        ins = _tensors(args, kwargs)
        self._note_foreign(ins)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self._note_new([t for t, f in zip(outs, info.fresh)
                        if f and isinstance(t, torch.Tensor)])
        if info.hidden is not None:
            during = self.live + _rounded(info.hidden(args))
            self.costs.peak_live_bytes = max(self.costs.peak_live_bytes,
                                             during)
        if info.free:
            return out
        self.costs.num_ops += 1
        out_tensors = _tensors(outs, {})
        self._add(func.overloadpacket.__name__,
                  sum(_nbytes(t) for t in ins)
                  + sum(_nbytes(t) for t in out_tensors),
                  info.rule(args, out) if info.rule is not None else 0.0)
        if func is _aten._to_copy.default or func is _aten.copy_.default:
            self._collective(func, args, ins, out_tensors)
        return out

    def _add(self, name: str, nbytes: float, flops: float) -> None:
        c = self.costs
        c.traffic_bytes += nbytes
        c.traffic_by_op[name] = c.traffic_by_op.get(name, 0.0) + nbytes
        if flops:
            c.flops += flops
            c.flops_by_op[name] = c.flops_by_op.get(name, 0.0) + flops

    def _collective(self, func, args, ins, outs) -> None:
        if func is _aten._to_copy.default:
            src, dst = ins[0].device, outs[0].device
        else:
            src, dst = args[1].device, args[0].device
        if src == dst or "cpu" in (src.type, dst.type):
            return
        nbytes = float(_nbytes(ins[0] if func is _aten._to_copy.default
                               else args[1]))
        c = self.costs
        c.collective_bytes["copy"] = (c.collective_bytes.get("copy", 0.0)
                                      + nbytes)
        c.collective_ops.append(("copy", str(func), nbytes, 1.0))

    # --- collectives ------------------------------------------------------

    def collective(self, kind: str, axes, nbytes: float, traffic: float,
                   fn: Callable):
        """``collectives.price_hook``: run ``fn`` unpriced, note its
        outputs' storages, and record the collective's price."""
        self.inside += 1
        try:
            out = fn()
        finally:
            self.inside -= 1
        self._note_new([t for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor)])
        if nbytes:
            c = self.costs
            c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) \
                + nbytes
            axis = "+".join(axes) or "none"
            c.collective_bytes_by_axis[axis] = (
                c.collective_bytes_by_axis.get(axis, 0.0) + nbytes)
            c.collective_ops.append((kind, axis, nbytes, 1.0))
            self._add(kind, traffic, 0.0)
        return out

    # --- kernels ----------------------------------------------------------

    def kernel(self, name: str, kernel: Callable, args, kw):
        bound = inspect.signature(kernel).bind(*args, **kw)
        bound.apply_defaults()
        nbytes, ops, peak = PRICES[name](bound.arguments)
        first = next(t for t in args if isinstance(t, torch.Tensor))
        self.inside += 1
        try:
            if first.device.type == "meta":
                plain = _plain(kernel)
                known = inspect.signature(plain).parameters
                out = plain(*args, **{k: v for k, v in kw.items()
                                      if k in known})
            else:
                out = kernel(*args, **kw)
        finally:
            self.inside -= 1
        k = self.costs.kernels.setdefault(name, KernelCost())
        k.launches += 1
        k.bytes += nbytes
        k.ops += ops
        k.bound_ms += kt.bound_ms(nbytes, ops, peak)[0]
        self._add(name, nbytes, ops)
        self._note_new([t for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor)])
        return out


def compute_costs(fn: Callable, *args, **kwargs) -> Costs:
    """Run ``fn(*args, **kwargs)`` once under the walk and return its
    :class:`Costs` (the call's result is dropped). The storages reachable
    from the arguments are the call's inputs, never its allocations."""
    if _build.cost_hook is not None:
        raise RuntimeError("an op-cost walk is already running")
    walk = _Walk()
    walk._note_foreign(_all_tensors((args, kwargs)))
    _build.cost_hook = walk.kernel
    col.price_hook = walk.collective
    t0 = time.perf_counter()
    try:
        with walk:
            result = fn(*args, **kwargs)
        walk.costs.output_bytes = sum(
            _nbytes(t) for t in _all_tensors(result)
            if t.untyped_storage()._cdata in walk._mine)
        del result
    finally:
        _build.cost_hook = None
        col.price_hook = None
    walk.costs.seconds = time.perf_counter() - t0
    for fin in list(walk._mine.values()) + list(walk._foreign.values()):
        fin.detach()
    return walk.costs


def _all_tensors(tree: Any) -> List[torch.Tensor]:
    """Every tensor in ``tree``: nested dicts, lists and tuples (model-axis
    ``Shards`` and ``AdamWState`` too), and the shards of
    ``ShardedLeaf`` s."""
    from repro_torch.distributed.sharding import ShardedLeaf

    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, ShardedLeaf):
            out.extend(x.shards.values())
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def meta_like(tree: Any) -> Any:
    """``tree`` (nested dicts, lists and tuples of tensors) with every
    tensor moved to the meta device without its data: the same dtype,
    shape, strides, storage offset and storage size, views of one
    storage kept views of one meta storage. Non-tensor leaves are kept.
    A serving cache comes from the meta model's own ``init_cache`` /
    ``init_paged_cache`` instead, which give its leaves the write
    scratch the cache writes check for."""
    storages: Dict[int, torch.UntypedStorage] = {}

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        s = t.untyped_storage()
        ms = storages.get(s._cdata)
        if ms is None:
            ms = storages[s._cdata] = torch.UntypedStorage(
                s.nbytes(), device="meta")
        out = torch.empty(0, dtype=t.dtype, device="meta")
        return out.set_(ms, t.storage_offset(), t.shape, t.stride())

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return one(x)

    return walk(tree)

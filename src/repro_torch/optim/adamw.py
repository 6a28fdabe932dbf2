"""AdamW on parameter dicts (port of ``repro.optim.adamw``): f32 first
and second moments whatever the parameter dtype (or ``momentum_dtype``),
decoupled weight decay on matrices only, bias correction in f32, a
global-norm clip, the factored second moment, the carried (unread)
gradient-compression state, schedules and microbatch accumulation.

Trees are the model's nested dicts of tensors; a factored second moment
is a ``{"row", "col"}`` dict where the parameter has a leaf. Unlike the
reference, :func:`update` writes the parameters and the moments **in
place**, leaf by leaf after the global norm, and returns the same
trees: a functional update would hold a second copy of every parameter
and moment, and casting the whole gradient tree to f32 at once (as the
reference's first line does) would add 4 bytes per parameter. The
arithmetic per element is the reference's.

A tree laid out over a mesh (``(data, model)``, or with 'pod') holds
:class:`~repro_torch.distributed.sharding.ShardedLeaf` leaves: the
moments mirror their parameters' shards (ZeRO), gradients arrive in the
same layout, and :func:`update` runs shard by shard. The global norm
sums every logical element once (a replicated shard is held once, on
pod 0 of a pod mesh, so no pod replica counts twice); the
factored second moment's ``row`` / ``col`` means run over the whole
logical axis (the shards' partial sums added in f32), and weight decay
follows the logical leaf's rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import (
    ShardedLeaf, share_leaf, shard_leaf, _spec_axes,
)

_F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any
    compression_error: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_compression: bool = False
    # Memory knobs for ≥20B-param configs (production Adafactor-style):
    # factored second moment stores row/col means instead of the full v
    # (O(r+c) vs O(r·c)); bf16 momentum halves mu.
    factored_second_moment: bool = False
    momentum_dtype: str = "float32"
    # Accumulate µbatch grads in bf16 (halves the gradient buffer; the
    # optimizer update still runs in f32).
    accum_dtype: str = "float32"
    # Apply the update layer-slice by layer-slice (a loop over the
    # stacked leading axis) so f32 elementwise temporaries are O(1/L).
    chunked_update: bool = False


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def tree_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of a nested dict in insertion order, paths
    ``/``-joined as the checkpoint names them."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += tree_leaves(v, f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over ``tree``'s leaves, with the matching subtrees of
    ``rest`` (a factored moment's ``{"row", "col"}`` dict arrives whole
    where ``tree`` has a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _is_factorable(p) -> bool:
    return len(p.shape) >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def _each(fn: Callable) -> Callable:
    """``fn`` over tensors, and shard by shard over sharded leaves."""
    def wrapped(p, *rest):
        if isinstance(p, ShardedLeaf):
            return p.map(fn, *rest)
        return fn(p, *rest)
    return wrapped


def _zeros(p, dtype=_F32, shape=None):
    if isinstance(p, ShardedLeaf):
        return p.map(lambda t: _zeros(t, dtype))
    return torch.zeros(p.shape if shape is None else shape, dtype=dtype,
                       device=p.device)


def _sharded_zeros(p: ShardedLeaf, spec, shape) -> ShardedLeaf:
    """Zeros of ``shape`` laid out by ``spec`` on ``p``'s mesh (a
    share's: its one shard)."""
    place = shard_leaf if p.mesh.coord is None else share_leaf
    return place(torch.zeros(shape, dtype=_F32,
                             device=p.mesh.first_device), spec, p.mesh)


def _init_nu(p, cfg: AdamWConfig):
    if cfg.factored_second_moment and _is_factorable(p):
        row, col = p.shape[:-1], p.shape[:-2] + p.shape[-1:]
        if isinstance(p, ShardedLeaf):  # the reference's row / col specs
            return {"row": _sharded_zeros(p, p.spec[:-1], row),
                    "col": _sharded_zeros(p, p.spec[:-2] + p.spec[-1:], col)}
        return {"row": _zeros(p, shape=row), "col": _zeros(p, shape=col)}
    return _zeros(p)


def _tensors(x) -> List[torch.Tensor]:
    """A leaf's tensors: itself, or a sharded leaf's shards in key
    order."""
    if isinstance(x, ShardedLeaf):
        return [x.shards[k] for k in sorted(x.shards)]
    return [x]


def init(params: Any, cfg: AdamWConfig) -> AdamWState:
    """Zero moments beside each parameter (each shard), on its device;
    the step an int32 scalar on the first parameter's device."""
    first = _tensors(tree_leaves(params)[0][1])[0]
    mu_dtype = _dtype(cfg.momentum_dtype)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(lambda p: _zeros(p, mu_dtype), params),
        nu=tree_map(lambda p: _init_nu(p, cfg), params),
        compression_error=(tree_map(lambda p: _zeros(p), params)
                           if cfg.grad_compression else None),
    )


def global_norm(tree: Any) -> torch.Tensor:
    """√(Σ leaves' sums of squares), each in f32; a sharded leaf's
    shards each once, on the first leaf's device."""
    parts = [t for _, x in tree_leaves(tree) for t in _tensors(x)]
    dev = parts[0].device
    sums = [x.to(_F32, copy=True).square_().sum().to(dev) for x in parts]
    total = torch.sum(torch.stack(sums))
    mesh = next((x.mesh for _, x in tree_leaves(tree)
                 if isinstance(x, ShardedLeaf)), None)
    if mesh is not None and mesh.coord is not None:
        # a share's shards: the other devices' sums, all-reduced
        axes = mesh.axis_names
        total = col.all_reduce([total], dev, axes=axes,
                               share=col.share_of(mesh, axes))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """``(grads · min(1, max_norm / ‖grads‖), ‖grads‖)``; new tensors."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def _update_leaf(p, g, m, v, *, scale, lr, bc1, bc2, cfg: AdamWConfig
                 ) -> None:
    """One parameter's AdamW step, in place on ``p``, ``m`` and ``v``
    (a factored ``v`` is its ``{"row", "col"}`` dict), in the
    reference's per-element arithmetic."""
    b1, b2 = cfg.b1, cfg.b2
    g32 = g.to(_F32, copy=True)
    if scale is not None:
        g32.mul_(scale)
    m32 = m.float()                     # m itself when f32
    m32.mul_(b1).add_(g32, alpha=1 - b1)
    if m32 is not m:
        m.copy_(m32)
        m32 = m.float()                 # the stored (rounded) moment
    g2 = g32.square_()
    if isinstance(v, dict):             # factored: row / col means
        v["row"].mul_(b2).add_(g2.mean(dim=-1), alpha=1 - b2)
        v["col"].mul_(b2).add_(g2.mean(dim=-2), alpha=1 - b2)
        row, col = v["row"] / bc2, v["col"] / bc2
        row_mean = torch.mean(row, dim=-1, keepdim=True)
        torch.mul((row / torch.clamp(row_mean, min=1e-30))[..., None],
                  col[..., None, :], out=g2)
    else:
        v.mul_(b2).add_(g2, alpha=1 - b2)
        torch.div(v, bc2, out=g2)
    denom = g2.sqrt_().add_(cfg.eps)
    delta = torch.div(m32, bc1).div_(denom)
    del g32, g2, denom
    if cfg.weight_decay > 0 and p.dim() >= 2:   # decay matrices only
        delta.add_(p, alpha=cfg.weight_decay)
    # p − lr·δ, rounded once to the parameter's dtype
    p.copy_(delta.mul_(lr).neg_().add_(p))


def _on_device(kw: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """The update's scalar tensors on a shard's device."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in kw.items()}


def _update_factored_sharded(p: ShardedLeaf, g: ShardedLeaf,
                             m: ShardedLeaf, v: Dict[str, ShardedLeaf], *,
                             scale, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    """:func:`_update_leaf`'s factored step for a sharded parameter. The
    mean of g² over the last (row) and second-to-last (col) logical axes
    adds each shard's partial sums in f32 in shard order, the stats are
    updated as logical tensors (O(rows + cols)) and written back to
    their own shards, and ``row_mean`` runs over the whole row axis;
    then each shard takes its slice of v̂ = row/row_mean ⊗ col."""
    from repro_torch.distributed.sharding import gather_leaf

    b1, b2 = cfg.b1, cfg.b2
    keys = sorted(p.shards)
    dev = p.shards[keys[0]].device
    r_n, c_n = p.shape[-2], p.shape[-1]
    row_sum = torch.zeros(p.shape[:-1], dtype=_F32, device=dev)
    col_sum = torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=_F32,
                          device=dev)

    def g32_of(k):
        g32 = g.shards[k].to(_F32, copy=True)
        if scale is not None:
            g32.mul_(scale.to(g32.device))
        return g32

    for k in keys:
        sl = p.slices(k)
        g2 = g32_of(k).square_()
        row_sum[sl[:-1]] += g2.sum(dim=-1).to(dev)
        col_sum[sl[:-2] + sl[-1:]] += g2.sum(dim=-2).to(dev)
    if p.mesh.coord is not None:    # a share: the other shards' sums
        axes = _spec_axes(p.spec)
        share = col.share_of(p.mesh, axes)
        row_sum = col.all_reduce([row_sum], dev, axes=axes, share=share)
        col_sum = col.all_reduce([col_sum], dev, axes=axes, share=share)
    stats = {}
    for name, total, n in (("row", row_sum, c_n), ("col", col_sum, r_n)):
        stat = gather_leaf(v[name], dev)
        stat.mul_(b2).add_(total / n, alpha=1 - b2)
        for key, shard in v[name].shards.items():
            shard.copy_(stat[v[name].slices(key)])
        stats[name] = stat / bc2.to(dev)
    row_mean = torch.mean(stats["row"], dim=-1, keepdim=True)
    row_n = stats["row"] / torch.clamp(row_mean, min=1e-30)
    for k in keys:
        sl = p.slices(k)
        pk, mk = p.shards[k], m.shards[k]
        kw = _on_device(dict(lr=lr, bc1=bc1), pk.device)
        g32 = g32_of(k)
        m32 = mk.float()
        m32.mul_(b1).add_(g32, alpha=1 - b1)
        if m32 is not mk:
            mk.copy_(m32)
            m32 = mk.float()
        del g32
        v_hat = (row_n[sl[:-1]][..., None]
                 * stats["col"][sl[:-2] + sl[-1:]][..., None, :]
                 ).to(pk.device)
        denom = v_hat.sqrt_().add_(cfg.eps)
        delta = torch.div(m32, kw["bc1"]).div_(denom)
        del v_hat, denom
        if cfg.weight_decay > 0 and p.ndim >= 2:   # the logical rank
            delta.add_(pk, alpha=cfg.weight_decay)
        pk.copy_(delta.mul_(kw["lr"]).neg_().add_(pk))


def update(grads: Any, state: AdamWState, params: Any, cfg: AdamWConfig
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step. Writes ``params`` and the moments in place, leaf
    by leaf, and returns ``(params, new_state, metrics)``; ``grads`` is
    left as it was. ``metrics`` holds the global norm before the clip
    and the learning rate."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm) if cfg.clip_norm > 0 else None
    step = state.step + 1
    stepf = step.to(_F32)
    if callable(cfg.learning_rate):
        lr = cfg.learning_rate(step)
    else:
        lr = torch.tensor(cfg.learning_rate, dtype=_F32, device=step.device)
    kw = dict(scale=scale, lr=lr, bc1=1.0 - torch.pow(cfg.b1, stepf),
              bc2=1.0 - torch.pow(cfg.b2, stepf), cfg=cfg)

    def one(p, g, m, v):
        if not isinstance(p, ShardedLeaf):
            one_tensor(p, g, m, v, kw)
        elif isinstance(v, dict):
            _update_factored_sharded(p, g, m, v, **kw)
        else:
            for k in sorted(p.shards):
                one_tensor(p.shards[k], g.shards[k], m.shards[k],
                           v.shards[k], _on_device(kw, p.shards[k].device))

    def one_tensor(p, g, m, v, kw):
        if cfg.chunked_update and p.dim() >= 3 and p.shape[0] >= 8:
            # slice by slice over the stacked layer axis: the f32
            # temporaries shrink from O(L·weights) to O(weights)
            for i in range(p.shape[0]):
                vi = ({k: x[i] for k, x in v.items()}
                      if isinstance(v, dict) else v[i])
                _update_leaf(p[i], g[i], m[i], vi, **kw)
        else:
            _update_leaf(p, g, m, v, **kw)

    with torch.no_grad():
        tree_map(one, params, grads, state.mu, state.nu)
    new_state = AdamWState(step=step, mu=state.mu, nu=state.nu,
                           compression_error=state.compression_error)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def warmup_cosine(
    peak_lr: float, warmup_steps: int, total_steps: int,
    final_frac: float = 0.1,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``final_frac · peak_lr``; f32 arithmetic, as the reference's."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(_F32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
        cos = peak_lr * (
            final_frac + (1 - final_frac) * 0.5
            * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def _grads(loss_fn: Callable, params: Any, batch: Dict[str, torch.Tensor]):
    """``(loss, grads, metrics)`` of ``loss_fn(params, batch)`` through
    ``torch.autograd.grad`` on detached aliases of the parameters (the
    caller's tensors never require grad and gather no ``.grad``)."""
    alias = tree_map(_each(lambda p: p.detach().requires_grad_()), params)
    inputs = [t for _, x in tree_leaves(alias) for t in _tensors(x)]
    loss, metrics = loss_fn(alias, batch)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    found = {id(x): torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)}
    detach = lambda x: x.detach() if isinstance(x, torch.Tensor) else x
    return (loss.detach(), tree_map(_each(lambda a: found[id(a)]), alias),
            {k: detach(v) for k, v in metrics.items()})


def accumulate_gradients(
    loss_fn: Callable, params: Any, batch: Dict[str, torch.Tensor],
    num_microbatches: int, accum_dtype: str = "float32",
) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """µbatch gradient accumulation (memory ∝ 1/µbatches).

    ``batch`` leading dim must divide by num_microbatches; loss_fn is
    ``(params, microbatch) -> (loss, metrics)``. Each microbatch's
    gradients come from ``torch.autograd.grad`` and add into an
    ``accum_dtype`` buffer (f32 by default: ``.grad`` would sum bf16
    leaves in bf16); the mean loss, the mean gradients and the last
    microbatch's metrics come back."""
    if num_microbatches <= 1:
        return _grads(loss_fn, params, batch)
    acc_dt = _dtype(accum_dtype)
    acc = tree_map(lambda p: _zeros(p, acc_dt), params)
    loss_sum = torch.zeros((), dtype=_F32,
                           device=_tensors(tree_leaves(params)[0][1])[0]
                           .device)
    micro = {k: x.reshape((num_microbatches, x.shape[0] // num_microbatches)
                          + tuple(x.shape[1:])) for k, x in batch.items()}
    metrics = {}
    for i in range(num_microbatches):
        loss, grads, metrics = _grads(loss_fn, params,
                                      {k: x[i] for k, x in micro.items()})
        tree_map(_each(lambda a, g: a.add_(g)), acc, grads)
        del grads
        loss_sum = loss_sum + loss
    scale = 1.0 / num_microbatches
    tree_map(_each(lambda a: a.mul_(scale)), acc)
    return loss_sum * scale, acc, metrics

"""Decoder block and stacks (port of ``repro.models.transformer``):
the full-sequence stack and the stack over a serving cache.

Layer parameters and cache leaves stay stacked on a leading ``[L]``
axis, as in the reference; the reference's ``lax.scan`` becomes a
Python loop that hands each layer views of its slice. Layers below
``prefix_layers`` run with layer index 0 (the unpruned, dense prefix of
§III-A), the rest with ``prefix_layers``, exactly as the reference's two
scans do. A layer that holds ``"moe"`` runs the MoE FFN in place of the
MLP; the full-sequence stack sums its auxiliary loss over the layers in
layer order, the serve stack discards it (as the reference's serve
steps do).

The full-sequence stack is differentiable and rematerializes per layer
(``remat``, the reference's ``cfg.remat``): ``"full"`` keeps only each
layer's input and recomputes the layer in the backward
(``torch.utils.checkpoint``, non-reentrant), ``"dots"`` also keeps the
outputs of the products without batch dims (a selective policy that
saves ``mm`` / ``addmm``: the projections, the MLP, the head — the
counterpart of ``dots_with_no_batch_dims_saveable``; batched products,
``bmm``, the attention scores and the experts, are recomputed),
``"none"`` keeps everything. The reference's two-level √L scan and its
``_barrier`` only decide where XLA places the saved carries; a Python
loop over layers saves exactly what the per-layer checkpoint saves, so
it is their counterpart.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core import EnergonConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter/cache tree (views, no copy); a
    tuple leaf (a pool's head shards) gives each shard's layer."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(t[i] for t in tree)
    return tree[i]


def num_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def block_step(params, x: torch.Tensor, attn_call, *, activation: str,
               norm: str, telemetry: bool = False,
               moe_cfg: Optional[moe_lib.MoEConfig] = None,
               with_aux: bool = False):
    """Pre-norm decoder block around ``attn_call(attn_params, x_normed)``:
    x + attention(norm(x)), then x + MLP(norm(x)) — or the MoE FFN with
    ``moe_cfg``. With ``telemetry`` ``attn_call`` returns ``(h, stats)``
    and so does the block, the stats passed through unchanged. With
    ``with_aux`` the block returns ``(x, aux)``: the MoE's auxiliary
    loss, None for the MLP."""
    h = attn_call(params["attn"], L.apply_norm(norm, params["norm_attn"], x))
    if telemetry:
        h, stats = h
    x = x + h
    h_in = L.apply_norm(norm, params["norm_mlp"], x)
    aux = None
    if moe_cfg is not None:
        h, metrics = moe_lib.apply_moe(params["moe"], h_in, moe_cfg,
                                       metrics=with_aux)
        aux = metrics.get("moe_aux_loss")
    else:
        h = L.apply_mlp(params["mlp"], h_in, activation)
    x = x + h
    if with_aux:
        return x, aux
    return (x, stats) if telemetry else x


def apply_block(
    params,
    x: torch.Tensor,
    energon: EnergonConfig,
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float,
    use_qk_norm: bool,
    activation: str,
    norm: str,
    window: Optional[int] = None,
    layer_index: int = 10**9,
    moe_cfg: Optional[moe_lib.MoEConfig] = None,
):
    """Pre-norm decoder block over the whole sequence. x ``[B, n, d]``.
    Returns ``(x, aux)``: the MoE's auxiliary loss, None for the MLP."""
    def attn_call(p, xn):
        return attn.attention_block(
            p, xn, energon,
            num_heads=num_heads,
            num_kv_heads=num_kv_heads,
            rope_theta=rope_theta,
            use_qk_norm=use_qk_norm,
            window=window,
            layer_index=layer_index,
        )

    return block_step(params, x, attn_call, activation=activation,
                      norm=norm, moe_cfg=moe_cfg, with_aux=True)


def _layers(params_stacked, windows, prefix_layers: int):
    """Each layer's ``(params, window, layer_idx)``: layers below
    ``prefix_layers`` with layer index 0, the rest with
    ``prefix_layers``."""
    for i in range(num_layers(params_stacked)):
        yield (layer_slice(params_stacked, i),
               None if windows is None else windows[i],
               0 if i < prefix_layers else prefix_layers)


def unstack(tree) -> List[Any]:
    """The layers of a stacked tree, each leaf ``unbind``-ed once along
    its leading axis: the same views as :func:`layer_slice`, but under
    autograd one ``UnbindBackward`` stacks the layers' gradients into
    the leaf, where an indexing per layer would each scatter into a zero
    tensor of the whole leaf."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        count = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(count)]
    if isinstance(tree, shd.ShardedLeaf):     # a mesh's shards, each unbound
        return shd.unstack_sharded(tree)
    return list(tree.unbind(0))


#: the ops whose outputs ``remat="dots"`` saves: the products without
#: batch dims (``x @ w`` over ``[B, n, d]`` runs as one ``mm``)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_fn(fn, remat: str):
    """``fn`` under the rematerialization policy ``remat`` (``none`` /
    ``full`` / ``dots``). Outside autograd the checkpoint is skipped:
    it saves nothing there."""
    if remat == "none":
        return fn
    if remat not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {remat!r}")
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def apply_stack(
    params_stacked: Dict[str, Any],
    x: torch.Tensor,
    windows: Optional[Sequence[int]],
    block_fn,
    *,
    remat: str = "none",
    prefix_layers: int = 0,
):
    """Run ``block_fn(params, x, window, layer_idx) -> (x, aux)`` over
    the stacked layers (``windows``: per-layer sizes, 0 ⇒ global), each
    layer under ``remat`` (:func:`remat_fn`); layers below
    ``prefix_layers`` run with layer index 0, the rest with
    ``prefix_layers``. Returns ``(x, aux)``, the layers' auxiliary
    losses summed in f32 in layer order from 0 (the reference's scan
    carry; exactly 0 where no layer has one)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    fn = remat_fn(block_fn, remat)
    for i, layer in enumerate(unstack(params_stacked)):
        window = None if windows is None else windows[i]
        x, a = fn(layer, x, window, 0 if i < prefix_layers else prefix_layers)
        if a is not None:
            aux = aux + a
    return x, aux


def apply_stack_decode(
    params_stacked: Dict[str, Any],
    x: torch.Tensor,
    caches: Dict[str, torch.Tensor],
    windows: Optional[Sequence[int]],
    step_fn,
    *,
    prefix_layers: int = 0,
    telemetry: bool = False,
):
    """Run ``step_fn(params, x, cache, window, layer_idx) -> x`` over the
    layers. Each step updates its cache slice in place, so the stacked
    ``caches`` hold every layer's new state when this returns. With
    ``telemetry`` the step returns ``(x, stats [B, 4])`` and this
    ``(x, stats)``, the layers' stats stacked to int32 ``[L, B, 4]``."""
    stats = []
    for layer, window, layer_idx in _layers(
            {"params": params_stacked, "cache": caches}, windows,
            prefix_layers):
        x = step_fn(layer["params"], x, layer["cache"], window, layer_idx)
        if telemetry:
            x, st = x
            stats.append(st)
    return (x, torch.stack(stats)) if telemetry else x

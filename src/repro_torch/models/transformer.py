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
steps do). The full-sequence stack is forward only: rematerialization
waits for the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core import EnergonConfig
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


def apply_stack(
    params_stacked: Dict[str, Any],
    x: torch.Tensor,
    windows: Optional[Sequence[int]],
    block_fn,
    *,
    prefix_layers: int = 0,
):
    """Run ``block_fn(params, x, window, layer_idx) -> (x, aux)`` over
    the stacked layers (``windows``: per-layer sizes, 0 ⇒ global).
    Returns ``(x, aux)``, the layers' auxiliary losses summed in f32 in
    layer order from 0 (the reference's scan carry; exactly 0 where no
    layer has one)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, window, layer_idx in _layers(params_stacked, windows,
                                            prefix_layers):
        x, a = block_fn(layer, x, window, layer_idx)
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

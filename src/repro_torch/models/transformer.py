"""Decoder stack over a serving cache (port of
``repro.models.transformer.apply_stack_decode``).

Layer parameters and cache leaves stay stacked on a leading ``[L]``
axis, as in the reference; the reference's ``lax.scan`` becomes a
Python loop that hands each layer views of its slice. Layers below
``prefix_layers`` run with layer index 0 (the unpruned, dense prefix of
§III-A), the rest with ``prefix_layers``, exactly as the reference's two
scans do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter/cache tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def num_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def apply_stack_decode(
    params_stacked: Dict[str, Any],
    x: torch.Tensor,
    caches: Dict[str, torch.Tensor],
    windows: Optional[Sequence[int]],
    step_fn,
    *,
    prefix_layers: int = 0,
) -> torch.Tensor:
    """Run ``step_fn(params, x, cache, window, layer_idx) -> x`` over the
    layers. Each step updates its cache slice in place, so the stacked
    ``caches`` hold every layer's new state when this returns."""
    n = num_layers(params_stacked)
    for i in range(n):
        layer_idx = 0 if i < prefix_layers else prefix_layers
        window = None if windows is None else windows[i]
        x = step_fn(
            layer_slice(params_stacked, i), x, layer_slice(caches, i),
            window, layer_idx,
        )
    return x

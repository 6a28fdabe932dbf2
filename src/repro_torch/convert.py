"""Carry reference (JAX) parameters into the port.

The reference's ``LMModel.init`` pytree, handed over as nested dicts of
numpy arrays (the caller runs ``jax.tree.map(np.asarray, params)``),
maps one to one onto the port's parameter dict: the same names and
layouts (``wq [d, H, hd]``, ``wk``/``wv [d, KV, hd]``, ``wo [H, hd, d]``,
``mlp.w_up/w_gate/w_down``, ``embed.table``, ``lm_head.w``,
``final_norm.scale`` (and LayerNorm's ``bias``), the q/k norms, an MoE
block's ``moe.router/w_up/w_gate/w_down``), blocks stacked on a leading
``[L]`` axis; a tied head has no ``lm_head``. The recurrent families'
cells (``mlstm`` / ``slstm``, ``mamba_pre`` / ``mamba_post`` /
``mamba_tail``) are stacked on their group axes, and the hybrid's
``shared`` block is not stacked. Each leaf takes the dtype
``model.init`` gives it — the model dtype, but an MoE router's and a
Mamba2 cell's ``a_log`` / ``dt_bias`` / ``d_skip`` float32 — on the
target device.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def to_torch_tree(tree: Any, device: DeviceLike = None,
                  dtype: Any = torch.float32) -> Any:
    """Nested dicts of numpy arrays → the same dicts of tensors; float
    leaves cast to ``dtype``, one dtype or a tree of them beside
    ``tree``'s leaves."""
    dev = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: to_torch_tree(
            v, dev, dtype[k] if isinstance(dtype, Mapping) else dtype)
            for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        # numpy has no bfloat16; float32 holds every bf16 value exactly
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=dev, dtype=dtype
        )
    return torch.from_numpy(np.array(arr)).to(dev)


def convert_params(np_params: Mapping, model) -> dict:
    """Reference parameter pytree (numpy leaves) → ``model``'s params.
    The tree must hold exactly the leaves, of the shapes, that
    ``model.init`` makes: a tied head has no ``lm_head``, LayerNorm a
    ``bias`` beside its ``scale``, the plain GELU MLP no ``w_gate``."""
    mismatch = _tree_mismatch(np_params, model.param_shapes(), "")
    if mismatch:
        raise KeyError("reference params do not fit the model: "
                       + "; ".join(mismatch))
    return to_torch_tree(np_params, model.device, model.param_dtypes())


def _tree_mismatch(tree, shapes, path: str) -> list:
    if not isinstance(shapes, Mapping):
        if isinstance(tree, Mapping):
            return [f"{path} is a subtree, expected a {shapes} leaf"]
        got = tuple(np.shape(tree))
        return [] if got == shapes else [f"{path} is {got}, not {shapes}"]
    if not isinstance(tree, Mapping):
        return [f"{path} is a leaf, expected a subtree"]
    name = (lambda k: f"{path}.{k}") if path else str
    out = [f"lacks {name(k)}" for k in shapes if k not in tree]
    out += [f"has {name(k)}, which the model does not use"
            for k in tree if k not in shapes]
    for k in shapes.keys() & tree.keys():
        out += _tree_mismatch(tree[k], shapes[k], name(k))
    return out

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

An optimizer state crosses the same way: :func:`convert_opt_state`
takes the reference's ``AdamWState`` (numpy leaves) to the port's, and
:func:`to_numpy_tree` brings any tree of the port back as numpy, so the
two packages can start training from one state.
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


def _tensor_of(arr, dev) -> torch.Tensor:
    """A numpy leaf as a tensor of its own dtype (bf16 kept)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def convert_opt_state(np_state, params):
    """The reference's ``AdamWState`` (numpy leaves: ``step``, ``mu``,
    ``nu`` — a factored moment's ``{"row", "col"}`` dicts included —,
    ``compression_error``) → the port's, each leaf in its own dtype on
    the params' device."""
    from repro_torch.optim import AdamWState
    from repro_torch.optim.adamw import tree_leaves

    dev = tree_leaves(params)[0][1].device

    def tree(x):
        if x is None:
            return None
        if isinstance(x, Mapping):
            return {k: tree(v) for k, v in x.items()}
        return _tensor_of(x, dev)

    return AdamWState(
        step=_tensor_of(np_state.step, dev).to(torch.int32),
        mu=tree(np_state.mu), nu=tree(np_state.nu),
        compression_error=tree(np_state.compression_error))


def to_numpy_tree(tree: Any) -> Any:
    """A tree of the port (dicts, NamedTuples such as ``AdamWState``,
    None subtrees) with each tensor leaf as numpy — bf16 as f32, which
    holds it exactly."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy_tree(v) for v in tree))
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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

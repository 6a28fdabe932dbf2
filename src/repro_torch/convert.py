"""Carry reference (JAX) parameters into the port.

The reference's ``LMModel.init`` pytree, handed over as nested dicts of
numpy arrays (the caller runs ``jax.tree.map(np.asarray, params)``),
maps one to one onto the port's parameter dict: the same names and
layouts (``wq [d, H, hd]``, ``wk``/``wv [d, KV, hd]``, ``wo [H, hd, d]``,
``mlp.w_up/w_gate/w_down``, ``embed.table``, ``lm_head.w``,
``final_norm.scale``, the q/k norms), blocks stacked on a leading
``[L]`` axis. Leaves are cast to the model dtype on the target device.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def to_torch_tree(tree: Any, device: DeviceLike = None,
                  dtype: torch.dtype = torch.float32) -> Any:
    """Nested dicts of numpy arrays → the same dicts of tensors."""
    dev = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: to_torch_tree(v, dev, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        # numpy has no bfloat16; float32 holds every bf16 value exactly
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=dev, dtype=dtype
        )
    return torch.from_numpy(np.array(arr)).to(dev)


def convert_params(np_params: Mapping, model) -> dict:
    """Reference parameter pytree (numpy leaves) → ``model``'s params."""
    expected = {"embed", "final_norm", "lm_head", "blocks"}
    missing = expected - set(np_params)
    if missing:
        raise KeyError(f"reference params lack {sorted(missing)}")
    return to_torch_tree(np_params, model.device, model.dtype)

"""Elastic scaling: resume any checkpoint on any mesh (port of
``repro.distributed.elastic``).

Checkpoints store *logical* (unsharded, host) arrays, so resharding to
a new topology is: build the new mesh, derive the specs from the same
logical rules, and lay each array out by them
(:func:`~repro_torch.distributed.sharding.shard_tree`). A job written on
a ``(2, 2, 2)`` ``(pod, data, model)`` mesh resumes on ``(4, 1)`` or on
one device without a format change, and the reverse; only throughput
changes.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as shd


def reshard_params(params_host: Any, mesh) -> Any:
    """Host (numpy or tensor) params → shards placed for ``mesh`` by
    :func:`~repro_torch.distributed.sharding.param_shardings`."""
    tree = shd._map_with_path(lambda _, a: torch.as_tensor(a), params_host)
    return shd.shard_tree(tree, shd.param_shardings(tree, mesh), mesh)


def _host(a) -> np.ndarray:
    t = a.detach().cpu()
    if t.dtype == torch.bfloat16:       # numpy has no bf16: widen exactly
        t = t.float()
    return t.numpy()


def gather_params(params: Any) -> Any:
    """Params (sharded or not) → a host numpy tree (logical layout)."""
    return shd._map_with_path(lambda _, a: _host(a),
                              shd.gather_tree(params, "cpu"))


def mesh_fingerprint(mesh) -> str:
    """``"data=4xmodel=2"`` (``"pod=2xdata=2xmodel=2"`` with 'pod'), or
    ``"unsharded"`` without a mesh: the reference's string."""
    if mesh is None:
        return "unsharded"
    return "x".join(f"{name}={mesh.shape[name]}" for name in mesh.axis_names)


def validate_elastic_resume(params_host: Any, old_fingerprint: str,
                            new_mesh: Optional[Any]) -> bool:
    """A resume is always valid shape-wise (logical layout); True when
    the topology changed."""
    return mesh_fingerprint(new_mesh) != old_fingerprint

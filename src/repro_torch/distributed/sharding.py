"""Page-pool sharding over a serving mesh (the serving half of
``repro.distributed.sharding``).

The reference lays its arrays out with ``NamedSharding`` s and lets
GSPMD place the computation; the port has no partitioner, so a sharded
pool is laid out by hand: :func:`shard_paged_cache` turns each
head-sharded leaf ``[L, KV, …]`` into a tuple of M leaves ``[L, KV/M,
…]``, one on each model-axis device, and the code that reads the pool
follows its layout (the fused ops run one shard-local core per shard;
the gathers of the other paths concatenate the shards' rows).

:func:`paged_pool_spec` is the reference's placement rule, spec for
spec. Where it shards page rows (KV heads indivisible by the model
axis) the port keeps the pool whole on the mesh's first device: the
reference computes those layers unsharded too (its fused ops' tensor
parallelism does not engage), so only the memory placement differs.

Expert parallelism: :func:`shard_experts` gives each model-axis device
its experts of the MoE leaves (the reference's ``P("model", …)`` slices
of ``w_up`` / ``w_gate`` / ``w_down``), which ``models/moe.py`` runs
shard by shard wherever :func:`expert_shards` says the reference would.

The training rules (parameter, batch and activation specs) are ROADMAP
A5: the port's train step runs on one device and refuses a mesh.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

_ACTIVE_MESH = None


def set_active_mesh(mesh) -> None:
    """Register the mesh the fused paged ops shard over (None: none)."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_active_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def active_mesh(mesh):
    """``mesh`` active for the body, the previous one restored after (so
    engines on different meshes can interleave on one host); a no-op for
    ``mesh=None``."""
    if mesh is None:
        yield
        return
    prev = get_active_mesh()
    set_active_mesh(mesh)
    try:
        yield
    finally:
        set_active_mesh(prev)


def paged_pool_spec(name: str, shape, mesh, page_size: int
                    ) -> Tuple[Optional[str], ...]:
    """The reference's ``paged_pool_pspec`` for one pool leaf of ``shape``
    (``None`` or ``"model"`` per dim):

    * ``k`` / ``v`` / ``k_codes`` ``[…, KV, pool_rows, hd]``: KV heads over
      'model' when divisible; else the page rows, when each shard holds
      whole pages (``(rows / M) % page_size == 0``); else replicated;
    * ``k_scale`` ``[…, KV, num_pages]``: the KV-head rule only.
    """
    ndim = len(shape)
    spec = [None] * ndim
    if "model" not in mesh.axis_names or ndim < 3:
        return tuple(spec)
    m = mesh.shape["model"]
    if name in ("k", "v", "k_codes") and ndim >= 4:
        kv_dim, row_dim = ndim - 3, ndim - 2
        if shape[kv_dim] % m == 0:
            spec[kv_dim] = "model"
        elif shape[row_dim] % m == 0 and (shape[row_dim] // m) % page_size == 0:
            spec[row_dim] = "model"
    elif name == "k_scale":
        kv_dim = ndim - 2
        if shape[kv_dim] % m == 0:
            spec[kv_dim] = "model"
    return tuple(spec)


def head_sharded(name: str, shape, mesh, page_size: int) -> bool:
    """Does the port split this stacked pool leaf ``[L, KV, …]`` by KV
    head over ``mesh`` (a model axis of at least 2 that divides KV)?"""
    return (mesh.shape.get("model", 1) > 1
            and paged_pool_spec(name, shape, mesh, page_size)[1] == "model")


def _placed(leaf: torch.Tensor, device: torch.device,
            scratch: int) -> torch.Tensor:
    """``leaf`` as a cache leaf on ``device``: itself where it lives
    there, else a copy with the write scratch after each layer."""
    from repro_torch.models import attention as attn

    if leaf.device == device:
        return leaf
    out = attn.stacked_leaf(leaf.shape[0], leaf.shape[1:], leaf.dtype,
                            device, scratch)
    out.copy_(leaf)
    return out


def shard_paged_cache(cache: Dict[str, torch.Tensor], mesh,
                      page_size: int) -> Dict[str, object]:
    """A stacked paged cache (leaves ``[L, KV, rows, hd]`` / ``[L, KV,
    pages]``) laid out over row 0 of ``mesh``: a head-sharded leaf
    becomes a tuple of M leaves ``[L, KV/M, …]``, shard s on model-axis
    device s, each allocated as a cache leaf (with the write scratch
    after each layer); every other leaf stays whole on the first
    device. The contents are copied, so a cache that has served keeps
    its rows."""
    from repro_torch.models import attention as attn

    devices = mesh.devices[0]
    m = len(devices)
    out = {}
    for name, leaf in cache.items():
        scratch = attn.paged_scratch(page_size, leaf.shape[-1])[name]
        if not head_sharded(name, leaf.shape, mesh, page_size):
            out[name] = _placed(leaf, devices[0], scratch)
            continue
        per = leaf.shape[1] // m
        shards = []
        for s, dev in enumerate(devices):
            part = attn.stacked_leaf(leaf.shape[0],
                                     (per,) + tuple(leaf.shape[2:]),
                                     leaf.dtype, dev, scratch)
            part.copy_(leaf[:, s * per:(s + 1) * per])
            shards.append(part)
        out[name] = tuple(shards)
    return out


# --------------------------------------------------------------------------
# expert parallelism
# --------------------------------------------------------------------------

#: the expert leaves of an MoE block (``[L, E, …]`` stacked)
EXPERT_LEAVES = ("w_up", "w_gate", "w_down")


def expert_shards(num_experts: int, mesh) -> int:
    """M where an MoE layer of ``num_experts`` runs expert-parallel on
    ``mesh`` (the reference's ``apply_moe`` condition: a model axis M > 1
    that divides the experts), else 1."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    m = mesh.shape["model"]
    return m if m > 1 and num_experts % m == 0 else 1


def _shard_on(part: torch.Tensor, device: torch.device) -> torch.Tensor:
    """An expert shard on ``device``: the view ``part`` where it lives
    there (a stacked ``[L, E/M, …]`` slice is not contiguous, but each
    layer's is, and it is never made so: at qwen3-moe's width one
    layer's copy is 4.83 GB), else a copy of those experts alone."""
    if part.device == device:
        return part
    out = torch.empty(part.shape, dtype=part.dtype, device=device)
    out.copy_(part)
    return out


def expert_leaf_shards(leaf, num_experts: int, devices):
    """One layer's expert leaf ``[E, …]`` as a tuple of M shards, shard s
    holding experts ``[s·E/M, (s+1)·E/M)`` on ``devices[s]``: a tuple
    from :func:`shard_experts` as it is, a whole leaf sliced."""
    m = len(devices)
    if isinstance(leaf, tuple):
        if len(leaf) != m:
            raise ValueError(f"{len(leaf)} expert shards on a model axis "
                             f"of {m}")
        return leaf
    per = num_experts // m
    return tuple(_shard_on(leaf[s * per:(s + 1) * per], dev)
                 for s, dev in enumerate(devices))


def shard_experts(params: Dict[str, object], mesh) -> Dict[str, object]:
    """A model's parameter tree with each MoE expert leaf ``[L, E, …]``
    split over row 0 of ``mesh``'s model axis: a tuple of M leaves ``[L,
    E/M, …]``, shard s on model-axis device s (views on the leaf's own
    device, copies of the shard's experts elsewhere). The router and
    every other leaf stay as they are (whole, on the first device). A
    tree without MoE blocks, or a mesh on which the experts do not run
    expert-parallel, is returned as is."""
    blocks = params.get("blocks")
    moe = blocks.get("moe") if isinstance(blocks, dict) else None
    if moe is None:
        return params
    e = moe["w_up"].shape[1]
    m = expert_shards(e, mesh)
    if m == 1:
        return params
    devices = mesh.devices[0]
    per = e // m
    sharded = dict(moe)
    for name in EXPERT_LEAVES:
        if name in moe:
            sharded[name] = tuple(
                _shard_on(moe[name][:, s * per:(s + 1) * per], dev)
                for s, dev in enumerate(devices))
    return dict(params, blocks=dict(blocks, moe=sharded))

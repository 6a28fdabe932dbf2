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
Under the ``"serve"`` rules profile the experts lie 2-D: experts over
'model' × d_ff over 'data' (``P("model", None, "data")`` for up / gate,
``P("model", "data", None)`` for down), fully resident
(:func:`serve_expert_shards`, read by ``moe.apply_moe_serve_2d``).

The training half (reference ``:26-336, 390-470``): the rule tables,
``MESH_MAP`` and the rules profile, :func:`logical_axes_for` and the
param / batch / cache specs, spec for spec the reference's on the
port's dict trees (a path is the tuple of keys down to the leaf). Specs
are tuples with one entry per dim: a mesh axis name, a tuple of them, or
None. Where the reference hands a pytree of ``NamedSharding`` s to pjit,
the port lays the tree out by hand: :func:`shard_tree` turns each leaf
into a :class:`ShardedLeaf`, the distinct shards its spec names, each
on the first mesh device of its replica group (an axis the spec does
not name replicates the shard over it, and the controller holds it
once), and :func:`gather_tree` turns it back. On a three-axis ``(pod,
data, model)`` mesh 'pod' folds into data parallelism (:func:`data_axes`):
the batch splits over the pod × data rows, pod major, and ZeRO still
shards over 'data' alone, each weight held once for every pod. The
train step reads a layer's shards through :func:`row_views`: the ZeRO
all-gather over 'data' (and, for a recurrent cell, over 'model') as
collectives whose backward sums every row's gradients — the pods' on
top of the data rows', in f32 in row order — into the shards
(:mod:`repro_torch.distributed.collectives`).

One device's share (``Mesh.share``, the dry run's ``--mesh``): the
same specs cut to one coordinate — :func:`share_tree` /
:func:`share_batch` / :func:`shard_cache` build the shards that device
holds, and nothing else (a 16 × 16 mesh's leaf is one tensor, not 256),
:func:`share_of` takes them out of a whole mesh's tree, and
:func:`row_views` of a share gathers with the priced stand-in
collectives (:mod:`repro_torch.distributed.collectives`), a model-axis
leaf keeping its logical shard index (``collectives.Shards``).
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import collectives as col
from repro_torch.launch.mesh import DATA_AXES

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

    devices = mesh.rows[0]
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


def _ff_dim(name: str) -> int:
    """An expert leaf's d_ff dim: ``w_down [E, f, d]``'s second-to-last,
    ``w_up`` / ``w_gate [E, d, f]``'s last (stacked or not)."""
    return -2 if name == "w_down" else -1


def expert_ff_shards(d_ff: int, mesh) -> int:
    """D where the ``"serve"`` profile lays the experts' d_ff over a data
    axis of D > 1 (``expert_ff → data``, where D divides it, as
    :func:`param_pspec`'s guard says), else 1."""
    if _RULES_PROFILE != "serve" or "data" not in mesh.axis_names:
        return 1
    d = mesh.shape["data"]
    return d if d > 1 and d_ff % d == 0 else 1


def expert_leaf_shards(leaf, num_experts: int, devices, name: str):
    """One layer's expert leaf ``[E, …]`` as a tuple of M shards, shard s
    holding experts ``[s·E/M, (s+1)·E/M)`` on ``devices[s]``: a tuple
    from :func:`shard_experts` as it is (a shard laid out 2-D over
    'data' gathered whole over d_ff onto ``devices[s]``), a whole leaf
    sliced."""
    m = len(devices)
    if isinstance(leaf, tuple):
        if len(leaf) != m:
            raise ValueError(f"{len(leaf)} expert shards on a model axis "
                             f"of {m}")
        return tuple(
            torch.cat([p.to(dev) for p in part], dim=_ff_dim(name))
            if isinstance(part, tuple) else part
            for part, dev in zip(leaf, devices))
    per = num_experts // m
    return tuple(_shard_on(leaf[s * per:(s + 1) * per], dev)
                 for s, dev in enumerate(devices))


def serve_expert_shards(params: Dict[str, object], num_experts: int,
                        mesh) -> Dict[Tuple[int, int], Dict[str, object]]:
    """One layer's experts as the ``"serve"`` profile lays them out:
    ``(i, s)`` → the leaves mesh device ``(data i, model s)`` holds,
    experts ``[s·E/M, (s+1)·E/M)`` × d_ff slice i of D (``P("model",
    None, "data")`` for up / gate, ``P("model", "data", None)`` for
    down). Each leaf may be whole (sliced here: views on its own
    device), :func:`shard_experts`' M-tuple, its M-tuple of D-tuples,
    or a :class:`ShardedLeaf` laid out by the serve profile's specs (a
    pod mesh's pod 0; a share's own ``(i, s)`` alone). On a pod mesh
    the devices are pod 0's: the pods hold replicas."""
    m = mesh.shape["model"]
    d_n = mesh.shape.get("data", 1)
    per = num_experts // m
    out = {}
    for i in range(d_n):
        for s in range(m):
            dev = mesh.device({"data": i, "model": s})
            leaves = {}
            for name in EXPERT_LEAVES:
                if name not in params:
                    continue
                leaf = params[name]
                if isinstance(leaf, ShardedLeaf):
                    key = leaf.key(data=i, model=s)
                    if key in leaf.shards:      # a share holds its own
                        leaves[name] = leaf.shards[key]
                    continue
                part = leaf[s] if isinstance(leaf, tuple) \
                    else leaf[s * per:(s + 1) * per]
                if isinstance(part, tuple):
                    part = part[i]
                elif d_n > 1:
                    dim = _ff_dim(name)
                    ff = part.shape[dim] // d_n
                    part = part.narrow(dim, i * ff, ff)
                leaves[name] = _shard_on(part, dev)
            if leaves:
                out[(i, s)] = leaves
    return out


def shard_experts(params: Dict[str, object], mesh) -> Dict[str, object]:
    """A model's parameter tree with each MoE expert leaf ``[L, E, …]``
    split over ``mesh``'s model axis: a tuple of M leaves ``[L, E/M,
    …]``, shard s on model-axis device s (views on the leaf's own
    device, copies of the shard's experts elsewhere). Under the
    ``"serve"`` profile on a data axis D > 1 that divides d_ff, shard s
    is itself a tuple of D leaves, d_ff slice i on device ``(data i,
    model s)`` (the reference's 2-D serving layout). The router and
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
    f_n = expert_ff_shards(moe["w_up"].shape[-1], mesh)
    per = e // m
    sharded = dict(moe)
    for name in EXPERT_LEAVES:
        if name not in moe:
            continue
        shards = []
        for s in range(m):
            part = moe[name][:, s * per:(s + 1) * per]
            if f_n == 1:
                shards.append(_shard_on(part, mesh.device({"model": s})))
                continue
            dim = _ff_dim(name)
            ff = part.shape[dim] // f_n
            shards.append(tuple(
                _shard_on(part.narrow(dim, i * ff, ff),
                          mesh.device({"data": i, "model": s}))
                for i in range(f_n)))
        sharded[name] = tuple(shards)
    return dict(params, blocks=dict(blocks, moe=sharded))


# --------------------------------------------------------------------------
# training rules (the reference's tables, verbatim)
# --------------------------------------------------------------------------

# name → trailing-dim logical axes (path-context dependent for qkv).
_ATTN_RULES = {
    "wq": ("embed", "heads", None),
    "wk": ("embed", "kv_heads", None),
    "wv": ("embed", "kv_heads", None),
    "wo": ("heads", None, "embed"),
}
_SSM_RULES = {
    # mLSTM qkv: ZeRO over data only; sLSTM's matrices replicate over
    # 'model' (a model-sharded dim of the recurrence would all-reduce
    # every timestep), ZeRO over 'data'.
    "wq": ("embed", None, None),
    "wk": ("embed", None, None),
    "wv": ("embed", None, None),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    "w_in": ("embed", "mlp"),
    "w_out": ("mlp", "embed"),
    "w_x": ("embed", None),
    "r_h": (None, None, None, None),
    "conv": (None, "mlp"),
    "w_if": ("mlp", None),
}
_GENERIC_RULES = {
    # the embedding table vocab-sharded (the lookup: a masked local
    # gather + a sum over 'model', layers.embed_tokens), the LM head's
    # vocab sharded (logits vocab-sharded), the MoE router replicated
    # (every model shard routes alike), the dense MLP
    "table": ("vocab", None),
    "w": (None, "vocab"),
    "router": (None, None),
    "w_up": ("embed", "mlp"),
    "w_gate": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
}
_MOE_RULES = {
    "w_up": ("experts", "embed", None),
    "w_gate": ("experts", "embed", None),
    "w_down": ("experts", None, "embed"),
}
_MOE_SERVE_RULES = {  # 2D expert TP: experts→model × d_ff→data
    "w_up": ("experts", None, "expert_ff"),
    "w_gate": ("experts", None, "expert_ff"),
    "w_down": ("experts", "expert_ff", None),
}
_REPLICATED = {"scale", "bias", "b_if", "a_log", "dt_bias", "d_skip"}

MESH_MAP = {
    "embed": "data",
    "embed_tp": "model",
    "heads": "model",
    "kv_heads": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ff": None,      # serve profile: → "data" (2D expert TP)
    None: None,
}

# "train" ZeRO-shards weights over 'data'; "serve" keeps them resident
# and 2D-shards the MoE expert FFNs (experts→model × d_ff→data)
_RULES_PROFILE = "train"


def set_rules_profile(profile: str) -> None:
    global _RULES_PROFILE
    if profile not in ("train", "serve"):
        raise ValueError(profile)
    _RULES_PROFILE = profile


def get_rules_profile() -> str:
    return _RULES_PROFILE


def _mesh_map():
    if _RULES_PROFILE == "serve":
        m = dict(MESH_MAP)
        m["embed"] = None
        m["expert_ff"] = "data"
        return m
    return MESH_MAP


def _names(path) -> Tuple[str, ...]:
    """A path as its keys: a tuple of keys, or a ``/``-joined string."""
    if isinstance(path, str):
        return tuple(k for k in path.split("/") if k)
    return tuple(str(k) for k in path)


def _shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, (tuple, list, torch.Size)):
        return tuple(leaf)
    return tuple(leaf.shape)


def logical_axes_for(path, ndim: int) -> Tuple[Optional[str], ...]:
    """Trailing-rule lookup for a leaf of rank ``ndim`` at ``path``;
    leading (stacked layer / group) dims → None. A factored moment's
    ``row`` / ``col`` statistic inherits its parameter's rule with the
    reduced dim removed (row drops the last axis, col the one before)."""
    names = _names(path)
    name = names[-1] if names else ""
    if name in ("row", "col") and len(names) >= 2:
        parent = logical_axes_for(names[:-1], ndim + 1)
        reduced = parent[:-1] if name == "row" else parent[:-2] + parent[-1:]
        return ((None,) * (ndim - len(reduced)) + reduced
                if len(reduced) <= ndim else (None,) * ndim)
    if name in _REPLICATED:
        return (None,) * ndim
    rules = None
    if name in ("wq", "wk", "wv", "wo"):
        rules = _ATTN_RULES if "attn" in names else _SSM_RULES
    elif name in ("w_up", "w_gate", "w_down") and "moe" in names:
        rules = _MOE_SERVE_RULES if _RULES_PROFILE == "serve" else _MOE_RULES
    elif name in _SSM_RULES and "cell" in names:
        rules = _SSM_RULES
    elif name in _GENERIC_RULES:
        rules = _GENERIC_RULES
    if rules is None or name not in rules:
        return (None,) * ndim
    trailing = rules[name]
    if len(trailing) > ndim:
        return (None,) * ndim
    return (None,) * (ndim - len(trailing)) + tuple(trailing)


def data_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes used for data parallelism ('pod' folds into DP)."""
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def _dp(mesh):
    """The data axes as one spec entry: a lone axis as its name (as
    ``PartitionSpec`` normalizes a one-axis tuple)."""
    dp = data_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def param_pspec(path, leaf, mesh) -> Tuple[Optional[str], ...]:
    """The reference's ``param_pspec``: each dim's logical axis through
    ``MESH_MAP``, None where the mesh lacks the axis or its size does
    not divide the dim (the divisibility guard: such a leaf stays whole
    over that axis)."""
    shape = _shape(leaf)
    mesh_map = _mesh_map()
    spec = []
    for size, ax in zip(shape, logical_axes_for(path, len(shape))):
        mesh_ax = mesh_map.get(ax)
        if (mesh_ax is None or mesh_ax not in mesh.axis_names
                or size % mesh.shape[mesh_ax]):
            spec.append(None)
        else:
            spec.append(mesh_ax)
    return tuple(spec)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(params_shapes: Any, mesh):
    """The spec of every leaf of a parameter (or moment) tree; leaves
    are tensors or shapes (:meth:`LMModel.param_shapes`)."""
    return _map_with_path(lambda p, leaf: param_pspec(p, leaf, mesh),
                          params_shapes)


def batch_pspec(leaf, mesh) -> Tuple:
    """Batch dim 0 over every DP axis when it divides, else replicated."""
    shape = _shape(leaf)
    if len(shape) == 0 or shape[0] % dp_size(mesh):
        return (None,) * len(shape)
    return (_dp(mesh),) + (None,) * (len(shape) - 1)


def batch_shardings(batch_shapes: Any, mesh):
    return _map_with_path(lambda _, leaf: batch_pspec(leaf, mesh),
                          batch_shapes)


def kv_cache_pspec(shape, mesh) -> Tuple:
    """An attention cache ``[..., B, KV, max_len, hd]``: batch over DP
    when divisible; 'model' prefers KV heads, else the sequence; a batch
    that does not shard spreads the sequence over 'data' too."""
    dp = _dp(mesh)
    n_dp = dp_size(mesh)
    ndim = len(shape)
    spec = [None] * ndim
    batch_dim, kv_dim, seq_dim = ndim - 4, ndim - 3, ndim - 2
    has_model = "model" in mesh.axis_names
    batch_sharded = shape[batch_dim] % n_dp == 0 and shape[batch_dim] > 1
    if batch_sharded:
        spec[batch_dim] = dp
    if has_model and shape[kv_dim] % mesh.shape["model"] == 0:
        spec[kv_dim] = "model"
    elif has_model and shape[seq_dim] % mesh.shape["model"] == 0:
        spec[seq_dim] = "model"
    if (not batch_sharded and "data" in mesh.axis_names
            and spec[seq_dim] is None
            and shape[seq_dim] % mesh.shape["data"] == 0):
        spec[seq_dim] = "data"
    elif (not batch_sharded and "data" in mesh.axis_names
          and spec[seq_dim] == "model"
          and shape[seq_dim] % (
              mesh.shape["model"] * mesh.shape["data"]) == 0):
        spec[seq_dim] = ("data", "model")
    return tuple(spec)


def cache_pspec(path, leaf, mesh) -> Tuple:
    """Decode-cache specs: ``k`` / ``v`` / ``k_codes`` by
    :func:`kv_cache_pspec`; ``k_scale`` ``[..., B, KV, n_kb]`` batch over
    DP; any other state its first dim that DP divides (and > 1)."""
    dp = _dp(mesh)
    n_dp = dp_size(mesh)
    names = _names(path)
    shape = _shape(leaf)
    spec = [None] * len(shape)
    if names and names[-1] in ("k", "v", "k_codes") and len(shape) >= 4:
        return kv_cache_pspec(shape, mesh)
    if names and names[-1] == "k_scale" and len(shape) >= 3:
        b_dim = len(shape) - 3
        if shape[b_dim] % n_dp == 0:
            spec[b_dim] = dp
        return tuple(spec)
    for d, size in enumerate(shape):
        if size % n_dp == 0 and size > 1:
            spec[d] = dp
            break
    return tuple(spec)


def cache_shardings(cache_shapes: Any, mesh):
    return _map_with_path(lambda p, leaf: cache_pspec(p, leaf, mesh),
                          cache_shapes)


# --------------------------------------------------------------------------
# the explicit layout
# --------------------------------------------------------------------------


def _entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names: none, one, or a tuple."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _spec_axes(spec) -> Tuple[str, ...]:
    return tuple(a for entry in spec for a in _entry_axes(entry))


class ShardedLeaf:
    """One leaf laid out over a mesh: ``shards`` maps each distinct
    shard's key — its index on every mesh axis, in ``mesh.axis_names``
    order, 0 on an axis ``spec`` does not name — to its tensor on
    ``mesh.device(key)``. A spec entry names an axis or a tuple of axes
    (split over their product, the first axis major). ``shape`` is the
    logical leaf's."""

    __slots__ = ("spec", "shape", "mesh", "shards")

    def __init__(self, spec, shape, mesh, shards: Dict[Tuple[int, ...],
                                                       torch.Tensor]):
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.mesh = mesh
        self.shards = shards

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def data_dim(self) -> Optional[int]:
        """The dim split over data axes ('pod' / 'data'), if any."""
        for i, entry in enumerate(self.spec):
            if any(a in DATA_AXES for a in _entry_axes(entry)):
                return i
        return None

    def model_dim(self) -> Optional[int]:
        for i, entry in enumerate(self.spec):
            if "model" in _entry_axes(entry):
                return i
        return None

    def index(self, *coord: int) -> Tuple[int, ...]:
        """The shard that the mesh device at ``coord`` addresses."""
        named = _spec_axes(self.spec)
        return tuple(c if a in named else 0
                     for a, c in zip(self.mesh.axis_names, coord))

    def key(self, **axes: int) -> Tuple[int, ...]:
        """The key with ``axes``' indices (axis name → index), 0 on the
        rest."""
        return tuple(axes.get(a, 0) for a in self.mesh.axis_names)

    def slices(self, key: Tuple[int, ...]) -> Tuple[slice, ...]:
        """The logical slice each dim of shard ``key`` covers."""
        at = dict(zip(self.mesh.axis_names, key))
        out = []
        for dim, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            if not axes:
                out.append(slice(None))
                continue
            size, n, k = self.shape[dim], 1, 0
            for a in axes:
                n *= self.mesh.shape[a]
                k = k * self.mesh.shape[a] + at[a]
            out.append(slice(k * size // n, (k + 1) * size // n))
        return tuple(out)

    def parts(self, dim: int, **fixed: int) -> List[torch.Tensor]:
        """The shards along ``dim`` in the order they concatenate (its
        axes row-major), the other axes at ``fixed`` (else 0)."""
        axes = _entry_axes(self.spec[dim])
        return [self.shards[self.key(**dict(fixed, **dict(zip(axes, idx))))]
                for idx in itertools.product(
                    *(range(self.mesh.shape[a]) for a in axes))]

    def map(self, fn, *others: "ShardedLeaf") -> "ShardedLeaf":
        """A leaf of the same layout whose shard ``k`` is ``fn(shard,
        *(o.shards[k]))``."""
        return ShardedLeaf(self.spec, self.shape, self.mesh, {
            k: fn(t, *(o.shards[k] for o in others))
            for k, t in self.shards.items()})

    def device_bytes(self, *coord: int) -> int:
        """The bytes the mesh device at ``coord`` addresses (its shard, a
        replicated one counted on every device of its group)."""
        t = self.shards[self.index(*coord)]
        return t.numel() * t.element_size()

    def __repr__(self) -> str:
        return (f"ShardedLeaf({self.shape}, spec={self.spec}, "
                f"{len(self.shards)} shards)")


def shard_leaf(x: torch.Tensor, spec, mesh) -> ShardedLeaf:
    """``x`` (logical, any device) laid out over ``mesh`` by ``spec``:
    one shard per index of the axes ``spec`` names, on the device at
    that index (0 on every other axis)."""
    named = _spec_axes(spec)
    if any(a not in mesh.axis_names for a in named) \
            or len(set(named)) != len(named):
        raise ValueError(f"spec {spec} on a mesh of axes {mesh.axis_names}")
    leaf = ShardedLeaf(spec, x.shape, mesh, {})
    for key in itertools.product(*(
            range(mesh.shape[a]) if a in named else (0,)
            for a in mesh.axis_names)):
        part = x[leaf.slices(key)]
        leaf.shards[key] = part.to(mesh.device(key), copy=True).contiguous()
    return leaf


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Logical tensors → :class:`ShardedLeaf` s placed by ``specs`` (a
    tree of the same structure, e.g. :func:`param_shardings`'). A
    factored moment's ``{"row", "col"}`` dict is a subtree like any
    other."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard_leaf(tree, specs, mesh)


def _coord_tuple(mesh) -> Tuple[int, ...]:
    return tuple(mesh.coord[a] for a in mesh.axis_names)


def share_leaf(x: torch.Tensor, spec, mesh) -> ShardedLeaf:
    """``x`` (logical, any device — a meta tensor costs nothing) laid out
    by ``spec`` over the share ``mesh``: a :class:`ShardedLeaf` holding
    the one shard the share's device addresses, on that device (empty
    where ``x`` or the device is meta)."""
    leaf = ShardedLeaf(spec, x.shape, mesh, {})
    key = leaf.index(*_coord_tuple(mesh))
    part = x[leaf.slices(key)]
    dev = mesh.first_device
    if "meta" in (part.device.type, dev.type):
        leaf.shards[key] = torch.empty(part.shape, dtype=part.dtype,
                                       device=dev)
    else:
        leaf.shards[key] = part.to(dev, copy=True).contiguous()
    return leaf


def share_tree(tree: Any, specs: Any, mesh) -> Any:
    """:func:`shard_tree` cut to the share ``mesh``: each leaf's one
    shard (:func:`share_leaf`)."""
    if isinstance(tree, dict):
        return {k: share_tree(v, specs[k], mesh) for k, v in tree.items()}
    return share_leaf(tree, specs, mesh)


def share_of(tree: Any, mesh) -> Any:
    """A whole mesh's sharded tree (:func:`shard_tree`, or a sharded
    cache) cut to the share ``mesh`` of it: each :class:`ShardedLeaf`
    keeps the shard ``mesh.coord`` addresses (the same tensor, no copy);
    other leaves are kept."""
    if isinstance(tree, dict):
        return {k: share_of(v, mesh) for k, v in tree.items()}
    if isinstance(tree, ShardedLeaf):
        key = tree.index(*_coord_tuple(mesh))
        return ShardedLeaf(tree.spec, tree.shape, mesh,
                           {key: tree.shards[key]})
    return tree


def share_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """The share's slice of each batch leaf by :func:`batch_pspec` (the
    whole leaf where the batch replicates)."""
    return {k: next(iter(share_leaf(v, batch_pspec(v, mesh),
                                    mesh).shards.values()))
            for k, v in batch.items()}


def share_bytes(tree: Any) -> int:
    """The bytes of every shard a tree's :class:`ShardedLeaf` s hold (a
    share's: its device's), plus its plain tensors'."""
    if isinstance(tree, dict):
        return sum(share_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(share_bytes(v) for v in tree)
    if isinstance(tree, ShardedLeaf):
        return sum(t.numel() * t.element_size()
                   for t in tree.shards.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def shard_cache(cache: Any, mesh, scratch: Optional[Dict[str, int]] = None
                ) -> Any:
    """A stacked decode cache (``LMModel.init_cache``: leaves ``[L, …]``)
    laid out by :func:`cache_shardings` over ``mesh`` — or, for a share,
    its one shard of each leaf —, every shard allocated as a cache leaf
    (``attention.stacked_leaf``, with ``scratch`` elements by leaf name
    after each layer: the K/V writes need them) and filled from the
    logical leaf (left zero where it is meta)."""
    from repro_torch.models import attention as attn

    specs = cache_shardings(cache, mesh)
    scratch = scratch or {}

    def one(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        out = ShardedLeaf(spec, leaf.shape, mesh, {})
        keys = ([out.index(*_coord_tuple(mesh))] if mesh.coord is not None
                else itertools.product(*(
                    range(mesh.shape[a]) if a in _spec_axes(spec) else (0,)
                    for a in mesh.axis_names)))
        for key in keys:
            sl = out.slices(key)
            part = leaf[sl]
            t = attn.stacked_leaf(part.shape[0], tuple(part.shape[1:]),
                                  part.dtype, mesh.device(key),
                                  scratch.get(path[-1], 0))
            if "meta" not in (t.device.type, part.device.type):
                t.copy_(part)
            out.shards[key] = t
        return out

    return _map_with_path(one, cache)


class CacheLayout:
    """How :func:`kv_cache_pspec` splits an attention cache leaf ``[…, B,
    KV, n, hd]``: its batch over the data axes (``batch_axes``, empty
    where the batch replicates), its KV heads into ``heads`` shards over
    ``head_axes``, its sequence into ``parts`` over ``seq_axes`` (each
    row-major)."""

    def __init__(self, leaf: ShardedLeaf):
        nd = leaf.ndim
        spec = leaf.spec
        self.leaf = leaf
        self.batch_axes = _entry_axes(spec[nd - 4])
        self.head_axes = _entry_axes(spec[nd - 3])
        self.seq_axes = _entry_axes(spec[nd - 2])
        shape = leaf.mesh.shape
        self.heads = math.prod(shape[a] for a in self.head_axes)
        self.parts = math.prod(shape[a] for a in self.seq_axes)

    def _key(self, fixed, j, s):
        at = dict(fixed)
        for axes, k in ((self.head_axes, j), (self.seq_axes, s)):
            for a in reversed(axes):
                k, at[a] = divmod(k, self.leaf.mesh.shape[a])
        return self.leaf.key(**at)

    def row_keys(self, row: int) -> Dict[Tuple[int, int], Tuple[int, ...]]:
        """Data row ``row``'s pieces: ``(j, s)`` → shard key. A share
        holds the one its coordinate addresses."""
        mesh = self.leaf.mesh
        if mesh.coord is not None:
            key = self.leaf.index(*_coord_tuple(mesh))
            at = dict(zip(mesh.axis_names, key))

            def flat(axes):
                k = 0
                for a in axes:
                    k = k * mesh.shape[a] + at[a]
                return k

            return {(flat(self.head_axes), flat(self.seq_axes)): key}
        fixed = {a: mesh.row_coord(row)[a] for a in self.batch_axes}
        return {(j, s): self._key(fixed, j, s)
                for j in range(self.heads) for s in range(self.parts)}


def row_shard(leaf: ShardedLeaf, row: int) -> torch.Tensor:
    """The shard of a leaf split (at most) over its batch's data axes that
    data row ``row`` holds (a share's own)."""
    mesh = leaf.mesh
    if mesh.coord is not None:
        return leaf.shards[leaf.index(*_coord_tuple(mesh))]
    coord = mesh.row_coord(row)
    return leaf.shards[leaf.key(**{a: coord[a] for a in _spec_axes(
        leaf.spec) if a in coord})]


def gather_leaf(leaf: ShardedLeaf, device=None) -> torch.Tensor:
    """The logical tensor of ``leaf`` on ``device`` (default: the mesh's
    first device)."""
    device = leaf.mesh.first_device if device is None else device
    first = next(iter(leaf.shards.values()))
    out = torch.empty(leaf.shape, dtype=first.dtype, device=device)
    for key, t in leaf.shards.items():
        out[leaf.slices(key)] = t.detach().to(device)
    return out


def gather_tree(tree: Any, device=None) -> Any:
    """:func:`shard_tree`'s inverse: every :class:`ShardedLeaf` as its
    logical tensor on ``device`` (other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, ShardedLeaf):
        return gather_leaf(tree, device)
    return tree


def sharded_leaves(tree: Any, prefix: str = ""):
    """``(path, ShardedLeaf)`` pairs in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from sharded_leaves(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, ShardedLeaf):
        yield prefix, tree


def device_bytes(tree: Any, mesh) -> List:
    """The bytes each mesh device addresses of a sharded tree, nested as
    ``mesh.devices`` (a D × M grid on a ``(data, model)`` mesh, P × D × M
    with 'pod'): what
    ``param_shardings`` gives each device."""
    leaves = [leaf for _, leaf in sharded_leaves(tree)]

    def grid(coord):
        if len(coord) == len(mesh.axis_names):
            return sum(leaf.device_bytes(*coord) for leaf in leaves)
        axis = mesh.axis_names[len(coord)]
        return [grid(coord + (i,)) for i in range(mesh.shape[axis])]

    return grid(())


def reckoned_bytes(shapes: Any, dtypes: Any, mesh) -> int:
    """What ``param_shardings`` gives every device, from shapes and
    dtypes alone: each leaf's bytes over the product of the mesh axes
    its :func:`param_pspec` names (the same on every device)."""
    total = 0

    def add(path, shape):
        nonlocal total
        spec = param_pspec(path, shape, mesh)
        split = math.prod(mesh.shape[a] for a in _spec_axes(spec))
        dtype = dtypes
        for k in path:
            dtype = dtype[k]
        total += math.prod(shape) * dtype.itemsize // split

    _map_with_path(add, shapes)
    return total


def unstack_sharded(leaf: ShardedLeaf) -> List[ShardedLeaf]:
    """The layers of a stacked leaf ``[L, …]`` (its first dim never
    sharded), each shard ``unbind`` -ed once: views, whose gradients
    stack back into the shard."""
    if leaf.spec[0] is not None:
        raise ValueError(f"a stacked leaf sharded on its layer axis: "
                         f"{leaf.spec}")
    parts = {k: t.unbind(0) for k, t in leaf.shards.items()}
    count = leaf.shape[0]
    return [ShardedLeaf(leaf.spec[1:], leaf.shape[1:], leaf.mesh,
                        {k: v[i] for k, v in parts.items()})
            for i in range(count)]


def batch_rows(batch_size: int, mesh) -> int:
    """The data rows a batch of ``batch_size`` splits over: the product
    of the data axes (pod × data) where it divides the batch (the
    reference's batch_pspec), else 1 — a replicated batch, which every
    row would compute alike."""
    d = dp_size(mesh)
    return d if batch_size % d == 0 and batch_size > 1 else 1


def row_views(tree: Any, mesh, rows: Sequence[int], *, whole: bool = False,
              quantized: bool = False) -> List[Any]:
    """Each data row's view of a sharded (sub)tree (``rows``: indices
    into ``mesh.rows``, pod major): every :class:`ShardedLeaf`
    all-gathered over the data axes its spec names onto the row (ZeRO: a
    layer gathers its shards before use, and the gather's backward sums
    the rows' gradients — every pod's and data row's, in f32 in row
    order — and hands each shard its slice), or broadcast to it where
    the spec replicates over them (its backward sums the rows'
    gradients the same way). A leaf the spec shards over 'model' becomes
    a tuple of M tensors, shard j on the row's device j (the
    tensor-parallel layers split their compute there), unless
    ``whole``, which all-gathers it over 'model' onto the row's first
    device as well; every other leaf — and every leaf on a model axis of
    1 — is one tensor there.
    ``quantized`` gathers over 'data' with int8 codes
    (:func:`collectives.quantized_all_gather`)."""
    if isinstance(tree, dict):
        per_key = {k: row_views(v, mesh, rows, whole=whole,
                                quantized=quantized)
                   for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()}
                for i in range(len(rows))]
    leaf = tree
    a, b = leaf.data_dim(), leaf.model_dim()
    gather = col.quantized_all_gather if quantized else col.all_gather
    if mesh.coord is not None:
        return [_share_view(leaf, mesh, a, b, whole, gather)] * len(rows)
    js = range(mesh.shape["model"]) if b is not None else [0]
    grid = mesh.rows
    per_j = []
    for j in js:
        targets = [grid[r][j] for r in rows]
        fixed = {"model": j} if b is not None else {}
        if a is not None:
            per_j.append(gather(leaf.parts(a, **fixed), a, targets,
                                axes=_entry_axes(leaf.spec[a])))
        else:
            per_j.append(col.broadcast(leaf.shards[leaf.key(**fixed)],
                                       targets, axes=mesh.data_axes))
    out = []
    for i, r in enumerate(rows):
        if b is None or len(per_j) == 1:
            out.append(per_j[0][i])
            continue
        shards = col.Shards(p[i] for p in per_j)
        if whole:
            out.append(col.all_gather(shards, b, [grid[r][0]],
                                      axes=("model",))[0])
        else:
            out.append(shards)
    return out


def uneven_head_views(attn: Dict[str, Any], mesh, row: int,
                      num_heads: int) -> Dict[str, Any]:
    """A row's attention view with the query heads split over 'model' as
    GSPMD splits them where the model axis M does not divide them: ``wq``
    and ``wo`` arrive whole (replicated over 'model', as ``param_pspec``
    keeps them) and shard j takes heads ``[j·c, min((j+1)·c, H))``, c =
    ⌈H/M⌉, of the replicated leaves — ``wq [d, H, hd]`` and the matching
    rows of ``wo [H, hd, d]`` — on the row's device j, as
    :class:`~repro_torch.distributed.collectives.Shards` (a share's one;
    :func:`~repro_torch.distributed.collectives.slices`, whose backward
    gathers the slices' gradients). A shard past the last head holds
    none. ``attn`` is returned as it is
    where the heads divide M, M is 1 or ``wq`` is sharded already."""
    m = mesh.shape.get("model", 1)
    if m == 1 or num_heads % m == 0 or isinstance(attn["wq"], tuple):
        return attn
    per = -(-num_heads // m)
    if mesh.coord is None:
        js, devices = list(range(m)), list(mesh.rows[row])
    else:
        js, devices = [mesh.coord["model"]], [mesh.first_device]
    bounds = []
    for j in js:
        lo = min(j * per, num_heads)
        bounds.append((lo, min((j + 1) * per, num_heads) - lo))

    def split(w: torch.Tensor, dim: int):
        return col.Shards(col.slices(w, dim, bounds, devices,
                                     axes=("model",)),
                          start=js[0], total=m)

    return dict(attn, wq=split(attn["wq"], -2), wo=split(attn["wo"], -3))


def _share_view(leaf: ShardedLeaf, mesh, a, b, whole: bool, gather):
    """:func:`row_views` of one leaf in a share: the local shard gathered
    over the data axes its spec names (priced stand-ins), the gradient
    summed over the data axes it replicates over, and over 'model' the
    share's one shard as :class:`~repro_torch.distributed.collectives.
    Shards` (its logical index kept) — or, ``whole``, gathered."""
    dev = mesh.first_device
    t = leaf.shards[leaf.index(*_coord_tuple(mesh))]
    if a is not None:
        axes = _entry_axes(leaf.spec[a])
        t = gather([t], a, [dev], axes=axes,
                   share=col.share_of(mesh, axes))[0]
    rest = tuple(x for x in mesh.data_axes
                 if x not in _spec_axes(leaf.spec))
    if rest:
        t = col.broadcast(t, [dev], axes=rest,
                          share=col.share_of(mesh, rest))[0]
    if b is None or mesh.shape["model"] == 1:
        return t
    if whole:
        return col.all_gather([t], b, [dev], axes=("model",),
                              share=col.share_of(mesh, ("model",)))[0]
    return col.Shards((t,), start=mesh.coord["model"],
                      total=mesh.shape["model"])


# --------------------------------------------------------------------------
# the reference's constraints, and what the explicit layout does instead
# --------------------------------------------------------------------------


def constrain(x, spec_names, allow_uneven: bool = False):
    """The reference pins an activation to a symbolic spec for GSPMD.
    The port has no partitioner: an activation lives where the code that
    made it put it (a data row's rows on the row's devices, a model
    shard's heads on its device), so this returns ``x`` as it is."""
    return x


def constrain_activations(x, mesh):
    """The reference pins ``[B, n, d]`` activations to batch-DP; the
    port's mesh step holds each data row's rows on that row
    (:func:`batch_rows`), so ``x`` is returned as it is."""
    return x


def constrain_like_params(grads, params_template=None):
    """The reference pins gradients to the parameters' specs so the DP
    sync lowers to a reduce-scatter. The port's gradients arrive in the
    shards' layout already — :func:`row_views`' gathers reduce-scatter
    them in their backward — so they are returned as they are."""
    return grads

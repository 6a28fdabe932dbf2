"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch
(port of ``repro.models.moe``'s single-device path).

The router is softmax-then-top-k with normalized combine weights, as in
OLMoE / Qwen3-MoE. Every row of a call is routed — a serve step's
sentinel rows of idle or ragged slots too — and its T·K assignments are
ranked per expert in the flattened ``[T·K]`` order; an expert keeps the
first ``capacity = max(1, int(T·K/E · capacity_factor))`` and drops the
rest (Switch / GShard). So one row's routing decides whether another
row's assignment is kept: the slots of a serve step are coupled through
capacity, in the reference as here.

The expert FFNs are batched matmuls over ``[E, C, d]`` buffers (the
reference computes them outside any Pallas kernel). The dispatch and the
combine make no host sync and no data-dependent shape, so a serve step
through this layer replays from a CUDA graph.

Expert parallelism (:func:`apply_moe_sharded`, the reference's
``_apply_moe_sharded``) engages as the reference's does: wherever the
active serve mesh's model axis M is > 1 and divides the experts. Shard s
holds experts ``[s·E/M, (s+1)·E/M)`` and runs them on model-axis device
s; each shard's partial output rounds to the layer's dtype, and the
partials add in f32 in shard order and round once (the reference's
``psum`` over 'model', as XLA computes it). With a data axis D > 1 (the
train step, or a direct call on a ``(D, M)`` mesh) each data row routes
its own tokens with the capacity of its ``t_local = B/D · n`` rows
(reference ``:222-224``), its experts all-gathered over 'data' first
(the train step's :func:`~repro_torch.distributed.sharding.row_views`,
int8 on the wire under ``quantized_weight_gather``), and the aux loss
and drop fraction are means over the rows (the reference's ``pmean``).
On a ``(pod, data, model)`` mesh the rows are the pod × data rows, pod
major, each with the capacity of its ``B/(P·D) · n`` tokens.

Under the ``"serve"`` rules profile a call of at most 4096 tokens takes
:func:`apply_moe_serve_2d` (the reference's ``_apply_moe_serve_2d``):
the experts lie experts → 'model' × d_ff → 'data', fully resident; every
device routes every token with the replicated f32 router into its
``[E/M, C, d]`` buffer, runs its d_ff slice of its experts (the
down-projection a partial over d_ff in the layer's dtype) and combines
in f32, and one f32 sum over the whole mesh assembles the output,
rounded once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_model: int
    d_ff: int                      # per-expert hidden dim
    activation: str = "swiglu"
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # int8-compressed ZeRO expert-weight gathers of the sharded training
    # path (an exact f32 reduce-scatter backward); elsewhere unread
    quantized_weight_gather: bool = False


def init_moe(cfg: MoEConfig, generator: Optional[torch.Generator], device,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The router ``[d, E]`` in float32 whatever ``dtype`` (the
    reference's), the experts ``w_up`` / ``w_gate`` ``[E, d, f]`` and
    ``w_down`` ``[E, f, d]`` in ``dtype``; the reference's
    truncated-normal stds."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def tn(shape, std, dt=dtype):
        return L.trunc_normal(shape, std, generator, device, dt)

    params = {
        "router": tn((d, e), d ** -0.5, torch.float32),
        "w_up": tn((e, d, f), d ** -0.5),
        "w_down": tn((e, f, d), f ** -0.5),
    }
    if cfg.activation in L.GATED_ACTIVATIONS:
        params["w_gate"] = tn((e, d, f), d ** -0.5)
    return params


def expert_ffn(params, buf: torch.Tensor, activation: str) -> torch.Tensor:
    """buf ``[E, C, d]`` → ``[E, C, d]``, batched over experts."""
    up = torch.bmm(buf, params["w_up"])
    if activation in L.GATED_ACTIVATIONS:
        gate = torch.bmm(buf, params["w_gate"])
        act = L.silu(gate) if activation == "swiglu" else L.gelu(gate)
        h = act * up
    elif activation == "gelu":
        h = L.gelu(up)
    else:
        raise ValueError(f"unknown activation {activation}")
    return torch.bmm(h, params["w_down"])


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Assignments each expert keeps in a call of ``tokens`` rows, in the
    reference's Python-float order."""
    return max(1, int(tokens * cfg.experts_per_token / cfg.num_experts
                      * cfg.capacity_factor))


def route(params, xt: torch.Tensor, cfg: MoEConfig):
    """The router over ``xt [T, d]``: ``(probs [T, E] f32, top_p [T, K]
    normalized, top_e [T, K] int64, flat_pos [T·K], keep [T·K] bool,
    capacity)``. ``jax.lax.top_k`` orders ties lower index first, and
    the order of a token's K slots decides the cumsum positions, so the
    top k come from a stable descending sort (``torch.topk`` leaves
    ties unordered)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    # each (token, slot)'s position in its expert's buffer: a cumsum over
    # the flattened (T·K) assignment order. The one-hot is a comparison
    # (F.one_hot checks its classes on the host), laid out [E, T·K] so
    # that the scan runs along the innermost dim: CUDA's scan over an
    # outer dim of T·K rows × E columns took 13.6 ms at T·K = 65536 on
    # an H100
    flat_e = top_e.reshape(-1)
    onehot = (torch.arange(e, device=xt.device)[:, None] == flat_e).to(
        torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    flat_pos = (pos * onehot).sum(dim=0)
    cap = capacity(xt.shape[0], cfg)
    return probs, top_p, top_e, flat_pos, flat_pos < cap, cap


def _experts_combine(p, xt: torch.Tensor, expert: torch.Tensor,
                     pos: torch.Tensor, keep: torch.Tensor,
                     weight: torch.Tensor, n_exp: int, cap: int,
                     activation: str) -> torch.Tensor:
    """Dispatch ``xt [T, d]``'s T·K assignments to ``n_exp`` experts of
    ``p`` (``[n_exp, …]`` leaves), run them and combine: ``[T, d]`` f32.
    ``expert`` / ``pos`` ``[T·K]`` are each assignment's buffer row,
    ``keep`` whether it owns it, ``weight`` its router prob.

    A kept assignment owns its ``(expert, pos)`` row; a dropped one
    writes to the scratch row past the ``n_exp·C`` buffer rows (the
    reference adds a zeroed row at its ``(expert, pos)``, which leaves
    that row as is — a plain write there would overwrite a kept one).
    Every assignment gathers its ``(expert, pos)`` output at weight 0
    where dropped (a NaN there spreads, as in the reference); each
    token's K contributions add in f32 left to right from zeros — no
    atomics, the same bits on every replay."""
    t, d = xt.shape
    k = expert.numel() // t
    slot = torch.where(keep, expert * cap + pos,
                       torch.full_like(expert, n_exp * cap))
    buf = torch.zeros((n_exp * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((slot,), xt[:, None].expand(t, k, d).reshape(t * k, d))
    out_buf = expert_ffn(p, buf[:n_exp * cap].view(n_exp, cap, d),
                         activation)
    gathered = out_buf[expert, pos]
    w = (weight * keep.float())[:, None]
    combined = (gathered.float() * w).view(t, k, d)
    out = torch.zeros((t, d), dtype=torch.float32, device=xt.device)
    for j in range(k):
        out = out + combined[:, j]
    return out


def _aux_loss(probs: torch.Tensor, top_e: torch.Tensor,
              cfg: MoEConfig) -> torch.Tensor:
    """The load-balancing auxiliary loss (Switch-style)."""
    e = cfg.num_experts
    me = probs.mean(dim=0)
    ce = (top_e[:, 0, None] == torch.arange(e, device=probs.device)).float(
    ).mean(dim=0)
    return cfg.router_aux_weight * e * torch.sum(me * ce)


def apply_moe(params, x: torch.Tensor, cfg: MoEConfig, metrics: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x ``[B, n, d]`` → (out ``[B, n, d]``, ``{"moe_aux_loss",
    "moe_drop_fraction"}``), op for op the reference's ``apply_moe``:
    where the active mesh's model axis is > 1 and divides the experts,
    :func:`apply_moe_serve_2d` under the ``"serve"`` rules profile for at
    most ``SERVE_2D_TOKENS`` tokens, else :func:`apply_moe_sharded`;
    elsewhere the single-device ``_apply_moe_reference``.
    ``metrics=False`` skips the metrics (an empty dict; the serve steps
    discard them, and the reference's jit drops their ops)."""
    mesh = shd.get_active_mesh()
    if shd.expert_shards(cfg.num_experts, mesh) > 1:
        if shd.get_rules_profile() == "serve":
            if x.shape[0] * x.shape[1] <= SERVE_2D_TOKENS:
                return apply_moe_serve_2d(params, x, cfg, mesh,
                                          metrics=metrics)
        elif shd.dp_size(mesh) > 1:
            raise ValueError(
                f"an MoE call on an active mesh of {shd.dp_size(mesh)} data "
                f"rows: the active mesh serves on (1, M); "
                f"the data axis — per-row capacity, the ZeRO all-gathers of "
                f"the experts and the int8 _quantized_all_gather — is the "
                f"train step's (runtime/train_loop.make_train_step(mesh=…)) "
                f"or apply_moe_sharded's on a (D, M) mesh")
        return apply_moe_sharded(params, x, cfg, mesh, metrics=metrics)
    if isinstance(params["w_up"], tuple):
        raise ValueError(
            "expert shards need their serve mesh active "
            "(repro_torch.distributed.sharding.active_mesh)")
    batch, n, d = x.shape
    t = batch * n
    xt = x.reshape(t, d)
    probs, top_p, top_e, flat_pos, keep, cap = route(params, xt, cfg)
    flat_e = top_e.reshape(-1)
    safe_pos = torch.where(keep, flat_pos, 0).long()
    out = _experts_combine(params, xt, flat_e, safe_pos, keep,
                           top_p.reshape(-1), cfg.num_experts, cap,
                           cfg.activation)
    out = out.reshape(batch, n, d).to(x.dtype)
    if not metrics:
        return out, {}
    return out, {
        "moe_aux_loss": _aux_loss(probs, top_e, cfg),
        "moe_drop_fraction": 1.0 - keep.float().mean(),
    }


def shard_route(flat_e: torch.Tensor, flat_pos: torch.Tensor,
                keep: torch.Tensor, s: int, e_local: int):
    """Shard s's view of the call's routing (:func:`route`'s ``[T·K]``
    experts, positions and keep): ``(safe_e, safe_pos, keep_s)``, its
    local expert and buffer row of each assignment it keeps, 0 and 0
    elsewhere. Every reference shard routes the same replicated tokens
    with the replicated router, so its shard-local cumsum (foreign
    experts in a trash class) gives each of its experts the global
    positions, and ``keep_s = keep ∧ lo ≤ expert < lo + E/M``."""
    lo = s * e_local
    keep_s = keep & (flat_e >= lo) & (flat_e < lo + e_local)
    safe_e = torch.where(keep_s, flat_e - lo, 0)
    safe_pos = torch.where(keep_s, flat_pos, 0).long()
    return safe_e, safe_pos, keep_s


def cross_shard_sum(partials, dtype: torch.dtype, device: torch.device,
                    share=None) -> torch.Tensor:
    """The shards' partial outputs (each in the layer's dtype) added in
    f32 in shard order on ``device`` and rounded once to ``dtype``: what
    the reference's ``psum`` over 'model' gives on XLA's CPU, bf16
    partials included (not a chain of bf16 adds) —
    :func:`collectives.all_reduce` (``share`` a share's place on
    'model')."""
    return col.all_reduce([p.to(dtype) for p in partials], device,
                          axes=("model",), share=share)


def _moe_row(params, x: torch.Tensor, cfg: MoEConfig, devices,
             metrics: bool):
    """One data row's expert-parallel MoE on its model devices: route
    ``x``'s tokens once on x's device (capacity from these tokens), then
    on each device s dispatch the assignments shard s keeps
    (:func:`shard_route`) into ``[E/M, C, d]``, run its experts and
    combine its K slots in f32, rounded to x's dtype; the partials meet
    in :func:`cross_shard_sum` (f32 in shard order, rounded once; its
    backward broadcasts). Returns ``(out, aux, kept)``: kept =
    Σ_s mean(keep_s) in shard order (None, None without metrics)."""
    up = params["w_up"]
    m = col.shard_total(up) if isinstance(up, tuple) else len(devices)
    first = col.shard_start(up) if isinstance(up, tuple) else 0
    share = col.shards_share(up) if isinstance(up, tuple) else None
    e, d = cfg.num_experts, x.shape[-1]
    e_local = e // m
    shards = {name: shd.expert_leaf_shards(params[name], e, devices, name)
              for name in shd.EXPERT_LEAVES if name in params}
    batch, n, _ = x.shape
    xt = x.reshape(batch * n, d)
    probs, top_p, top_e, flat_pos, keep, cap = route(params, xt, cfg)
    flat_e = top_e.reshape(-1)
    xts = col.broadcast(xt, devices, axes=("model",), share=share)
    weights = col.broadcast(top_p.reshape(-1), devices, axes=("model",),
                            share=share)
    partials, kept = [], []
    for i, dev in enumerate(devices):
        safe_e, safe_pos, keep_s = shard_route(flat_e, flat_pos, keep,
                                               first + i, e_local)
        p_s = {name: leaves[i] for name, leaves in shards.items()}
        part = _experts_combine(
            p_s, xts[i], safe_e.to(dev), safe_pos.to(dev), keep_s.to(dev),
            weights[i], e_local, cap, cfg.activation)
        partials.append(part.to(x.dtype))
        if metrics:
            kept.append(keep_s.float().mean())
    out = cross_shard_sum(partials, x.dtype, x.device,
                          share).reshape(batch, n, d)
    if not metrics:
        return out, None, None
    total = kept[0]
    for part in kept[1:]:
        total = total + part
    return out, _aux_loss(probs, top_e, cfg), total


def _row_mean(values, device, mesh) -> torch.Tensor:
    """The rows' scalars averaged: summed in f32 in row order on
    ``device`` over their count (the reference's ``pmean`` over the data
    axes)."""
    axes = shd.data_axes(mesh)
    return col.all_reduce([v.reshape(()) for v in values], device,
                          axes=axes, share=col.share_of(mesh, axes)
                          ) / len(values)


def moe_rows(row_params, x_rows, cfg: MoEConfig, mesh, rows,
             metrics: bool = True):
    """The reference's ``_apply_moe_sharded`` over the data rows
    ``rows`` of a mesh (``mesh.rows``: pod × data, pod major): row r's
    tokens ``x_rows[i]`` [B/(P·D), n, d] on its devices with ``row_params[i]`` (its experts as M-tuples,
    already gathered over 'data', or whole leaves, sliced here).
    Returns ``(out_rows, metrics)``, ``moe_aux_loss`` and
    ``moe_drop_fraction`` the means over the rows."""
    outs, aux, kept = [], [], []
    for i, r in enumerate(rows):
        out, a, k = _moe_row(row_params[i], x_rows[i], cfg,
                             mesh.rows[r], metrics)
        outs.append(out)
        aux.append(a)
        kept.append(k)
    if not metrics:
        return outs, {}
    dev = x_rows[0].device
    return outs, {"moe_aux_loss": _row_mean(aux, dev, mesh),
                  "moe_drop_fraction": 1.0 - _row_mean(kept, dev, mesh)}


def apply_moe_sharded(params, x: torch.Tensor, cfg: MoEConfig, mesh,
                      metrics: bool = True
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``_apply_moe_sharded`` on a mesh whose model axis
    divides the experts, for whole parameters and the whole ``x [B, n,
    d]``: the batch splits over the data rows (pod × data) where their
    count divides it (else one row computes it, as every replicated row
    would), each row routing its own tokens with their capacity
    (:func:`moe_rows`), and the rows' outputs come back concatenated on
    x's device. The expert leaves are whole ``[E, …]`` leaves (sliced
    per shard) or the serve mesh's M-tuples
    (:func:`~repro_torch.distributed.sharding.shard_experts`). On a
    ``(1, M)`` mesh ``moe_aux_loss`` is the single-device loss and
    ``moe_drop_fraction`` 1 − Σ_s mean(keep_s), summed in shard
    order."""
    n_rows = shd.batch_rows(x.shape[0], mesh)
    if n_rows == 1:
        out, aux, kept = _moe_row(params, x, cfg, mesh.rows[0], metrics)
        if not metrics:
            return out, {}
        return out, {"moe_aux_loss": aux, "moe_drop_fraction": 1.0 - kept}
    per = x.shape[0] // n_rows
    rows = list(range(n_rows))
    x_rows = [x[r * per:(r + 1) * per].to(mesh.rows[r][0]) for r in rows]
    outs, met = moe_rows([params] * n_rows, x_rows, cfg, mesh, rows,
                         metrics)
    out = torch.cat([o.to(x.device) for o in outs], dim=0)
    return out, met


#: the most tokens a ``"serve"``-profile call sends through
#: :func:`apply_moe_serve_2d` (the reference's decode-sized bound)
SERVE_2D_TOKENS = 4096


def apply_moe_serve_2d(params, x: torch.Tensor, cfg: MoEConfig, mesh,
                       metrics: bool = True
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``_apply_moe_serve_2d`` on a ``(data, model)``
    mesh (D × M) whose model axis divides the experts and whose data
    axis divides d_ff: device ``(i, s)`` holds experts ``[s·E/M,
    (s+1)·E/M)`` × d_ff slice i
    (:func:`~repro_torch.distributed.sharding.serve_expert_shards`: whole
    leaves, ``shard_experts``' tuples), and every device sees every token
    (the reference gathers them over the data axes where the batch
    divides them, and replicates them otherwise: the same rows either
    way). The tokens are routed once with the replicated f32 router —
    the capacity ``max(1, int(T·K/E · cf))`` of all T tokens — and
    device ``(i, s)`` dispatches the assignments shard s keeps into its
    ``[E/M, C, d]`` buffer, runs its slice of its experts (the
    down-projection a partial over d_ff in x's dtype) and combines its
    K slots in f32 (:func:`_experts_combine`). One f32 sum over the
    whole mesh, in ``(data, model)`` row-major order, assembles the
    partials (the reference's ``psum`` over ``("model", "data")``); the
    result rounds once to x's dtype. ``moe_aux_loss`` is the
    single-device loss and ``moe_drop_fraction`` 1 − Σ_s mean(keep_s),
    summed in shard order.

    No host sync and no data-dependent shape: a serve step through this
    layer replays from a CUDA graph. On a 'pod' axis > 1 the pods are
    replicas: each sums its own ``(model, data)`` partials, so the layer
    equals the one-pod layer bit for bit (the reference's psum over
    ``("model", "pod", "data")`` adds every pod's copy — ROADMAP §C),
    and the one controller computes pod 0's. In a share
    (``Mesh.share``) the device ``(data, model)`` of its coordinate runs
    its slice alone, and the sum is its priced stand-in."""
    e, m = cfg.num_experts, mesh.shape["model"]
    d_n = mesh.shape.get("data", 1)
    if e % m or cfg.d_ff % d_n:
        raise ValueError(
            f"the 2-D expert layout needs the model axis {m} to divide the "
            f"{e} experts and the data axis {d_n} to divide d_ff {cfg.d_ff}")
    e_local = e // m
    batch, n, d = x.shape
    xt = x.reshape(batch * n, d)
    probs, top_p, top_e, flat_pos, keep, cap = route(params, xt, cfg)
    flat_e = top_e.reshape(-1)
    shards = shd.serve_expert_shards(params, e, mesh)
    keys = sorted(shards)                       # (data, model) row-major
    devices = [mesh.device({"data": i, "model": s}) for i, s in keys]
    axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    share = col.share_of(mesh, axes)
    xts = col.broadcast(xt, devices, axes=axes, share=share)
    weights = col.broadcast(top_p.reshape(-1), devices, axes=axes,
                            share=share)
    routes = {s: shard_route(flat_e, flat_pos, keep, s, e_local)
              for s in sorted({s for _, s in keys})}
    partials = []
    for k, ((i, s), dev) in enumerate(zip(keys, devices)):
        safe_e, safe_pos, keep_s = routes[s]
        partials.append(_experts_combine(
            shards[(i, s)], xts[k], safe_e.to(dev), safe_pos.to(dev),
            keep_s.to(dev), weights[k], e_local, cap, cfg.activation))
    out = col.all_reduce(partials, x.device, axes=axes[::-1],
                         share=share).to(
        x.dtype).reshape(batch, n, d)
    if not metrics:
        return out, {}
    kept = None
    for _, _, keep_s in routes.values():
        part = keep_s.float().mean()
        kept = part if kept is None else kept + part
    return out, {"moe_aux_loss": _aux_loss(probs, top_e, cfg),
                 "moe_drop_fraction": 1.0 - kept}

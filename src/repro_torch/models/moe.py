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
through this layer replays from a CUDA graph. The expert-parallel paths
of the reference (``_apply_moe_sharded``, ``_apply_moe_serve_2d``) are
not ported: :func:`mesh_fault` names the meshes on which the reference
would take them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

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
    # int8-compressed expert-weight gathers of the reference's sharded
    # training path; the single-device path ignores it
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


def apply_moe(params, x: torch.Tensor, cfg: MoEConfig, metrics: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x ``[B, n, d]`` → (out ``[B, n, d]``, ``{"moe_aux_loss",
    "moe_drop_fraction"}``), op for op the reference's
    ``_apply_moe_reference``. ``metrics=False`` skips the metrics (an
    empty dict; the serve steps discard them, and the reference's jit
    drops their ops)."""
    batch, n, d = x.shape
    t = batch * n
    xt = x.reshape(t, d)
    e, k = cfg.num_experts, cfg.experts_per_token
    probs, top_p, top_e, flat_pos, keep, cap = route(params, xt, cfg)
    flat_e = top_e.reshape(-1)
    safe_pos = torch.where(keep, flat_pos, 0).long()
    # Dispatch into [E, C, d]: a kept assignment owns its (e, pos) row;
    # a dropped one writes to the scratch row past the E·C buffer rows
    # (the reference adds a zeroed row at (e, 0), which leaves that row
    # as is — a plain write there would overwrite a kept one)
    slot = torch.where(keep, flat_e * cap + safe_pos,
                       torch.full_like(flat_e, e * cap))
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((slot,), xt[:, None].expand(t, k, d).reshape(t * k, d))
    out_buf = expert_ffn(params, buf[:e * cap].view(e, cap, d),
                         cfg.activation)

    # Combine: gather each slot's output at (e, safe_pos) and weight it
    # by its router prob, 0 where dropped (a NaN there spreads, as in the
    # reference); each token's K contributions summed in f32 left to
    # right from zeros — no atomics, the same bits on every replay
    gathered = out_buf[flat_e, safe_pos]
    w = (top_p.reshape(-1) * keep.float())[:, None]
    combined = (gathered.float() * w).view(t, k, d)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + combined[:, j]
    out = out.reshape(batch, n, d).to(x.dtype)
    if not metrics:
        return out, {}

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = (top_e[:, 0, None] == torch.arange(e, device=x.device)).float(
    ).mean(dim=0)
    aux = cfg.router_aux_weight * e * torch.sum(me * ce)
    return out, {
        "moe_aux_loss": aux,
        "moe_drop_fraction": 1.0 - keep.float().mean(),
    }


def mesh_fault(cfg, mesh) -> Optional[str]:
    """Why a model of ``cfg`` (a ``ModelConfig``) cannot serve on
    ``mesh``, or None. The reference runs an MoE layer on its
    expert-parallel paths (whose cross-shard sums round in bf16)
    wherever the active mesh's model axis is > 1 and divides the
    experts, and the port has only the single-device path. A mesh whose
    model axis is 1 runs the single-device path in the reference too."""
    if cfg.family != "moe" or mesh is None or "model" not in mesh.axis_names:
        return None
    m = mesh.shape["model"]
    if m > 1 and cfg.num_experts % m == 0:
        return (f"{cfg.name}: an MoE model ({cfg.num_experts} experts) on a "
                f"mesh with model axis {m} takes the reference's "
                f"expert-parallel paths, which the port does not have yet; "
                f"serve it on a mesh whose model axis is 1")
    return None

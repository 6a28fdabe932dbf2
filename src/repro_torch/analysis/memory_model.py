"""Analytic per-chip HBM traffic model for the roofline memory term (port
of ``repro.analysis.memory_model``, arithmetic for arithmetic).

Why analytic: the op-cost walk (``repro_torch.analysis.op_costs``)
counts the port's eager program, one kernel per op, so its traffic is
the unfused traffic; the quantities that dominate the traffic of a
well-fused step are known exactly from the configuration, so they are
counted directly:

train (per chip per step):
  * weight streams — each µbatch reads this chip's TP shard of every
    layer's (ZeRO-gathered) weights: fwd + remat-recompute + bwd ≈ 3
    passes, plus the gathered copies being written once;
  * optimizer — params/grads/moments read+write once per step;
  * activations — the layer-scan saves ≈(outer+inner) residual carries
    (write+read), and each layer streams its activation working set a
    small constant number of times;
  * attention — MP-MRF filter reads int8 K planes over the full
    sequence; the AU streams only the β-selected K/V blocks (ODF).

decode: params one pass + cache traffic (filter plane over the full
cache + β-fraction at attention precision) + state updates.
"""

from __future__ import annotations

import math
from typing import Dict

from repro_torch.analysis.flops import param_counts
from repro_torch.configs.base import ModelConfig, ShapeConfig


def _bytes_of(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4}.get(dtype, 2)


def hbm_traffic_bytes(
    cfg: ModelConfig,
    shape: ShapeConfig,
    chips: int,
    model_shards: int,
    num_microbatches: int,
    pruning_ratio: float = 4.0,
    opt_factored: bool = False,
) -> Dict[str, float]:
    counts = param_counts(cfg)
    p_total = counts["total"]
    act_b = _bytes_of(cfg.dtype)
    d = cfg.d_model
    tokens = shape.global_batch * shape.seq_len

    if shape.kind == "train":
        # --- weights: per-chip TP shard of every layer, per µbatch ---
        per_chip_weights = p_total * act_b / model_shards
        weight_traffic = per_chip_weights * num_microbatches * (3 + 1)
        # --- optimizer (params bf16, grads, mu, nu) ---
        opt_bytes = p_total * (
            act_b + act_b + (2 if opt_factored else 4)
            + (0.05 if opt_factored else 4)
        ) / chips
        opt_traffic = 2 * opt_bytes
        # --- activations: saved carries + per-layer streams ---
        tok_per_chip_mb = tokens * d * act_b / chips / num_microbatches
        saved = 2 * int(2 * math.sqrt(max(cfg.num_layers, 1))) \
            * tok_per_chip_mb * num_microbatches
        streams = 8 * cfg.num_layers * tok_per_chip_mb * num_microbatches
        # --- attention: filter int8 full-K + AU β-selected K/V ---
        kv_heads_dim = cfg.num_kv_heads * cfg.head_dim
        per_layer_kv = tokens * kv_heads_dim / chips
        attn = cfg.num_layers * per_layer_kv * (
            1.0 + 2 * act_b / pruning_ratio
        ) * 3
        total = weight_traffic + opt_traffic + saved + streams + attn
        return {
            "weights": weight_traffic, "optimizer": opt_traffic,
            "activations": saved + streams, "attention": attn,
            "total": total,
        }

    if shape.kind == "prefill":
        per_chip_weights = p_total * act_b / model_shards
        tok_per_chip = tokens * d * act_b / chips
        streams = 6 * cfg.num_layers * tok_per_chip
        kv_heads_dim = cfg.num_kv_heads * cfg.head_dim
        attn = cfg.num_layers * tokens * kv_heads_dim / chips * (
            1.0 + 2 * act_b / pruning_ratio
        )
        total = per_chip_weights + streams + attn
        return {"weights": per_chip_weights, "optimizer": 0.0,
                "activations": streams, "attention": attn, "total": total}

    # decode: one token per sequence
    per_chip_weights = counts["active"] * act_b / model_shards
    kv_heads_dim = cfg.num_kv_heads * cfg.head_dim
    cache_entries = shape.global_batch * shape.seq_len * kv_heads_dim
    attn_layers = cfg.num_layers
    if cfg.family == "ssm":
        attn_layers = 0
    elif cfg.family == "hybrid" and cfg.hybrid_attn_every:
        attn_layers = cfg.num_layers // cfg.hybrid_attn_every
    elif cfg.global_every:
        n_global = cfg.num_layers // cfg.global_every
        n_local = cfg.num_layers - n_global
        # local layers touch only their window
        window_frac = min(1.0, cfg.sliding_window / max(shape.seq_len, 1))
        cache_traffic = (
            n_global * cache_entries * (1.0 + 2 * act_b / pruning_ratio)
            + n_local * cache_entries * window_frac * (1 + 2 * act_b)
        ) / chips
        ssm_traffic = 0.0
        total = per_chip_weights + cache_traffic
        return {"weights": per_chip_weights, "optimizer": 0.0,
                "activations": ssm_traffic, "attention": cache_traffic,
                "total": total}
    # MP-MRF decode: int8 filter plane over full cache + β of bf16 K/V
    cache_traffic = attn_layers * cache_entries * (
        1.0 + 2 * act_b / pruning_ratio
    ) / chips
    # recurrent states (ssm/hybrid) read+write
    ssm_traffic = 0.0
    if cfg.family in ("ssm", "hybrid"):
        d_in = 2 * cfg.d_model
        state = shape.global_batch * d_in * max(cfg.ssm_state, 64) * 4
        ssm_traffic = 2 * cfg.num_layers * state / chips
    total = per_chip_weights + cache_traffic + ssm_traffic
    return {"weights": per_chip_weights, "optimizer": 0.0,
            "activations": ssm_traffic, "attention": cache_traffic,
            "total": total}

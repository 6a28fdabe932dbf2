"""Analytic FLOP / parameter accounting (port of ``repro.analysis.flops``).

Parameter counts are exact: they come from :meth:`LMModel.init`'s tree
built on the meta device (nothing is allocated, nothing is drawn).
MODEL_FLOPS follows the standard convention: 6·N·D for training (N =
non-embedding params, D = tokens) and 2·N_active·D for forward-only
inference steps; MoE uses active (routed) params only. Used for the
"useful compute" ratio of ``repro_torch.analysis.roofline``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(path, tensor)`` for every leaf of a nested dict, the path's
    keys joined by ``/`` (the reference's ``_path_str``)."""
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            yield from _leaves(value, path)
        else:
            yield path, value


def param_counts(cfg: ModelConfig) -> Dict[str, int]:
    """Exact counts from the real init on the meta device. The buckets
    are the reference's: ``embedding`` is the embedding table and the
    untied LM head (``embed/table``, ``lm_head``), ``expert`` every MoE
    leaf but the router (``/moe/``)."""
    from repro_torch.models import LMModel

    params = LMModel(cfg, device="meta").init()
    total = 0
    embedding = 0
    expert = 0
    for path, leaf in _leaves(params):
        n = leaf.numel()
        total += n
        if "embed/table" in path or "lm_head" in path:
            embedding += n
        if "/moe/" in path and "router" not in path:
            expert += n
    active = total
    if cfg.family == "moe" and cfg.num_experts > 0:
        active = total - expert + expert * cfg.experts_per_token // cfg.num_experts
    return {
        "total": total,
        "embedding": embedding,
        "non_embedding": total - embedding,
        "expert": expert,
        "active": active,
        "active_non_embedding": active - embedding,
    }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for one step of this (arch × shape) cell."""
    counts = param_counts(cfg)
    n_active = counts["active_non_embedding"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one new token per sequence (the KV-cache attention FLOPs
    # are the *attention* workload, not parameter compute — they are
    # accounted separately in the roofline attention terms).
    return 2.0 * n_active * shape.global_batch

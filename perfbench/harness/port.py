"""The system under test: the port's model at a configuration file's sizes.

The port's registered serving configuration is used as it is, and held
to the file: every size and every Energon setting the file states must
be what the port runs, or the cell refuses to start.
"""

from __future__ import annotations

from typing import Dict, Optional


def model_config(spec: Dict, smoke_layers: Optional[int] = None):
    """The port's ``ModelConfig`` for ``spec``. ``smoke_layers`` (tests
    only) takes the registry's smoke widths at that depth instead."""
    import dataclasses

    from repro_torch.configs import registry

    if smoke_layers is not None:
        cfg = registry.get_serve_config(spec["registry"], smoke=True)
        return dataclasses.replace(cfg, num_layers=smoke_layers)
    cfg = registry.get_serve_config(spec["registry"])
    en = spec["energon"]
    stated = {
        "num_layers": spec["num_hidden_layers"],
        "d_model": spec["hidden_size"],
        "num_heads": spec["num_attention_heads"],
        "num_kv_heads": spec["num_key_value_heads"],
        "head_dim": spec["head_dim"],
        "d_ff": spec["intermediate_size"],
        "vocab_size": spec["vocab_size"],
        "rope_theta": float(spec["rope_theta"]),
        "num_experts": spec.get("num_experts", 0),
        "experts_per_token": spec.get("num_experts_per_tok", 0),
        "tie_embeddings": spec["tie_word_embeddings"],
        "dtype": spec["torch_dtype"],
    }
    if "capacity_factor" in spec:
        stated["capacity_factor"] = float(spec["capacity_factor"])
    runs = {k: getattr(cfg, k) for k in stated}
    e = cfg.energon
    stated_e = {"impl": en["impl"],
                "pruning_ratio": float(en["pruning_ratio"]),
                "key_block": en["key_block"],
                "decode_key_block": en["decode_key_block"],
                "query_block": en["query_block"],
                "round_bits": tuple(en["round_bits"]),
                "alphas": tuple(float(a) for a in en["alphas"]),
                "min_prune_layer": en["dense_layers"],
                "chunk_threshold": en["chunk_threshold"]}
    runs_e = {k: getattr(e, k) for k in stated_e}
    if runs != stated or runs_e != stated_e:
        raise ValueError(f"the port's {spec['registry']} serving config "
                         f"{runs} {runs_e} is not the file's {stated} "
                         f"{stated_e}")
    return cfg


def smoke_spec(cfg, registry_name: str) -> Dict:
    """A configuration file's keys for a port config (the tests' smoke
    widths)."""
    e = cfg.energon
    spec = {
        "registry": registry_name, "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": cfg.tie_embeddings, "torch_dtype": cfg.dtype,
        "energon": {"impl": e.impl, "pruning_ratio": e.pruning_ratio,
                    "key_block": e.key_block,
                    "decode_key_block": e.decode_key_block,
                    "query_block": e.query_block,
                    "round_bits": list(e.round_bits),
                    "alphas": list(e.alphas),
                    "dense_layers": e.min_prune_layer,
                    "chunk_threshold": e.chunk_threshold},
    }
    if cfg.num_experts:
        spec.update(num_experts=cfg.num_experts,
                    num_experts_per_tok=cfg.experts_per_token,
                    capacity_factor=cfg.capacity_factor)
    return spec

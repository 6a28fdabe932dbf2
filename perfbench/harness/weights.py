"""Weights made from the seed, in the layout the port serves and scores.

The layout and the scales come from the configuration file alone, at the
scales the reference package initializes with: a normal clipped at two
standard deviations, of std ``fan_in^-½`` for each projection and 1 for
the embedding, and unit norm scales. The model multiplies the embedding
by ``d_model^½``, so each block adds a small step to a large residual
stream and a deep stack stays stable: rounding in one layer does not
grow through the next forty (a unit-scale residual stream with these
projections is chaotic, and bf16 then departs from float32 as far as a
lower precision does). Drawn on the device by one ``torch.Generator``,
one call per stacked leaf, in the dtype the model is served in (the
router in float32). The same seed gives the same tree, so the reference
re-makes the weights rather than reading the program's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

#: the seed's stream for weights, apart from the traffic's
WEIGHT_STREAM = 0x5EED


def _sizes(spec: Dict):
    d, L = spec["hidden_size"], spec["num_hidden_layers"]
    h, kv, hd = (spec["num_attention_heads"], spec["num_key_value_heads"],
                 spec["head_dim"])
    return d, L, h, kv, hd, spec["vocab_size"]


def leaves(spec: Dict) -> List[Tuple[Tuple[str, ...], tuple, float, bool]]:
    """``(path, shape, std, float32)`` of every leaf, in draw order; std 0
    marks a norm scale (ones)."""
    d, L, h, kv, hd, v = _sizes(spec)
    out = [
        (("embed", "table"), (v, d), 1.0, False),
        (("final_norm", "scale"), (d,), 0.0, False),
        (("lm_head", "w"), (d, v), d ** -0.5, False),
        (("blocks", "norm_attn", "scale"), (L, d), 0.0, False),
        (("blocks", "attn", "wq"), (L, d, h, hd), d ** -0.5, False),
        (("blocks", "attn", "wk"), (L, d, kv, hd), d ** -0.5, False),
        (("blocks", "attn", "wv"), (L, d, kv, hd), d ** -0.5, False),
        (("blocks", "attn", "wo"), (L, h, hd, d), (h * hd) ** -0.5, False),
        (("blocks", "attn", "q_norm", "scale"), (L, hd), 0.0, False),
        (("blocks", "attn", "k_norm", "scale"), (L, hd), 0.0, False),
        (("blocks", "norm_mlp", "scale"), (L, d), 0.0, False),
    ]
    e, f = spec.get("num_experts", 0), spec["intermediate_size"]
    if e:
        out += [
            (("blocks", "moe", "router"), (L, d, e), d ** -0.5, True),
            (("blocks", "moe", "w_up"), (L, e, d, f), d ** -0.5, False),
            (("blocks", "moe", "w_down"), (L, e, f, d), f ** -0.5, False),
            (("blocks", "moe", "w_gate"), (L, e, d, f), d ** -0.5, False),
        ]
    else:
        out += [
            (("blocks", "mlp", "w_up"), (L, d, f), d ** -0.5, False),
            (("blocks", "mlp", "w_down"), (L, f, d), f ** -0.5, False),
            (("blocks", "mlp", "w_gate"), (L, d, f), d ** -0.5, False),
        ]
    return out


def make(spec: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The weight tree for ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 2654435761 + WEIGHT_STREAM) % 2 ** 63)
    tree: Dict = {}
    for path, shape, std, f32 in leaves(spec):
        dt = torch.float32 if f32 else dtype
        if std == 0.0:
            leaf = torch.ones(shape, dtype=dt, device=device)
        else:
            leaf = torch.randn(shape, generator=gen, dtype=dt, device=device)
            leaf.clamp_(-2.0, 2.0).mul_(std)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def shapes(tree: Dict) -> Dict:
    """The tree's leaf shapes, nested alike."""
    return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}

"""Shared neural layers (port of ``repro.models.layers``): initializers,
RMSNorm, RoPE, the SwiGLU MLP, embedding and LM head.

Parameters are plain dicts of tensors with the reference's layouts, so
:mod:`repro_torch.convert` can carry a reference pytree across as is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# Φ(-2), Φ(2): the standard normal truncated to [-2, 2]
_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def trunc_normal(shape, std: float, generator: torch.Generator, device,
                 dtype=torch.float32) -> torch.Tensor:
    """``std`` × a standard normal truncated to [-2, 2] (the reference's
    ``std * jax.random.truncated_normal(key, -2, 2)``), drawn by inverse
    CDF in float32 from ``generator`` and cast to ``dtype``."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = _LO + (_HI - _LO) * u
    x = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return (std * torch.clamp(x, -2.0, 2.0)).to(dtype)


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 statistics, applied in the input dtype."""
    xf = x.float()
    var = (xf * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x ``[..., n, heads, hd]`` (head-last), positions
    ``[..., n]``; f32 math, output in x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mlp(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """SwiGLU MLP (the gated activations of the other archs wait for
    their slice)."""
    if activation != "swiglu":
        raise NotImplementedError(f"activation {activation!r}")
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def lm_logits(params, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32: products of the stored-precision operands
    accumulated in f32, as the reference's
    ``preferred_element_type=float32``."""
    return x.float() @ params["w"].float()

"""Shared neural layers (port of ``repro.models.layers``): initializers,
RMSNorm and LayerNorm, RoPE, the SwiGLU / GeGLU / GELU MLPs, embedding,
the LM head (untied and tied) and the cross-entropy loss.

Parameters are plain dicts of tensors with the reference's layouts, so
:mod:`repro_torch.convert` can carry a reference pytree across as is.

On a training mesh a data row's view of a weight that the model axis
shards is a tuple of M tensors, shard j on the row's device j
(:func:`repro_torch.distributed.sharding.row_views`); the layers below
then split their compute as the reference's specs do: the embedding
vocab-parallel (a masked local gather, then a sum over 'model'), the
LM head vocab-sharded (a tuple of logit shards), the cross-entropy over
those shards (a cross-shard max and log-sum-exp, the gold logit read on
its owning shard), and the MLP column- then row-parallel (a sum over
'model'). Every cross-shard sum is a
:mod:`~repro_torch.distributed.collectives` op: f32 in shard order,
rounded once.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed import collectives as col

# Φ(-2), Φ(2): the standard normal truncated to [-2, 2]
_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def trunc_normal(shape, std: float, generator: torch.Generator, device,
                 dtype=torch.float32) -> torch.Tensor:
    """``std`` × a standard normal truncated to [-2, 2] (the reference's
    ``std * jax.random.truncated_normal(key, -2, 2)``), drawn by inverse
    CDF in float32 from ``generator`` and cast to ``dtype``."""
    # in place, op for op the out-of-place chain (the same bits): one f32
    # buffer of the leaf's size at a time (an expert leaf of qwen3-moe is
    # 3.2 GB in f32)
    x = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    x.mul_(_HI - _LO).add_(_LO).mul_(2.0).sub_(1.0).erfinv_()
    x.mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)
    return x.to(dtype)


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 statistics, applied in the input dtype."""
    xf = x.float()
    var = (xf * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with f32 statistics, applied in the input dtype (the
    reference's rounding: ``F.layer_norm`` rounds differently in bf16)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    out = (x - mu.to(x.dtype)) * inv
    return out * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def apply_norm(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(params, x)
    if kind == "layernorm":
        return layernorm(params, x)
    raise ValueError(f"unknown norm {kind}")


def init_norm(kind: str, d: int, dtype, device) -> dict:
    """RMSNorm's unit scale; LayerNorm's too, and its zero bias."""
    if kind not in ("rmsnorm", "layernorm"):
        raise ValueError(f"unknown norm {kind}")
    params = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        params["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return params


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


#: the MLPs with a gate projection (``w_gate``); ``gelu`` has none
GATED_ACTIVATIONS = ("swiglu", "geglu")
#: the tanh GELU's √(2/π) and 0.044715 rounded to each dtype, as the
#: reference's weakly typed constants are
_GELU_CONSTANTS = {
    dt: tuple(torch.tensor(c, dtype=dt).item()
              for c in (math.sqrt(2.0 / math.pi), 0.044715))
    for dt in (torch.float32, torch.bfloat16, torch.float16)
}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default tanh form, op for op in x's dtype.
    ``F.gelu(approximate="tanh")`` rounds once, and so parts from the
    reference in the last bf16 bit."""
    c, k = _GELU_CONSTANTS[x.dtype]
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it: x · (1 / (1 + exp(−x))) op by
    op, each op's f32 result rounded to x's dtype (as torch's ops in x's
    dtype round), with XLA's denormal mode on top. XLA flushes subnormal
    operands and results to zero, which changes exactly two kinds of
    output: |x| < 2^−125, whose x · 0.5 (or x itself) is subnormal, and
    1 + exp(−x) > 2^126, whose reciprocal is; both give x · 0 (±0).
    ``F.silu`` rounds once and keeps subnormals, and so parts from the
    reference in bf16 on 1866 of the 65280 finite inputs; this matches
    it on all of them (``tests/test_torch_dense_configs.py``)."""
    a = 1.0 + torch.exp(-x)
    y = x * torch.reciprocal(a)
    flushed = (x.abs() < 2.0 ** -125) | (a > 2.0 ** 126)
    return torch.where(flushed, x * 0.0, y)


def _mlp(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    up = x @ params["w_up"]
    if activation == "swiglu":
        h = silu(x @ params["w_gate"]) * up
    elif activation == "geglu":
        h = gelu(x @ params["w_gate"]) * up
    elif activation == "gelu":
        h = gelu(up)
    else:
        raise ValueError(f"unknown activation {activation}")
    return h @ params["w_down"]


def _devices(shards) -> list:
    return [t.device for t in shards]


def _like(shards, items) -> col.Shards:
    """``items`` as model-axis shards with ``shards``' logical indices."""
    return col.Shards(items, start=col.shard_start(shards),
                      total=col.shard_total(shards))


def apply_mlp(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """SwiGLU (:func:`silu`), GeGLU or plain GELU MLP (:func:`gelu`'s
    tanh form). With M-tuple weights (a mesh row's view): shard j runs
    the columns of ``w_up`` / ``w_gate`` and the rows of ``w_down`` it
    holds on its device, and the partial outputs (in x's dtype) meet in
    an f32 sum over 'model'."""
    if not isinstance(params["w_up"], tuple):
        return _mlp(params, x, activation)
    devices = _devices(params["w_up"])
    share = col.shards_share(params["w_up"])
    xs = col.broadcast(x, devices, axes=("model",), share=share)
    parts = [_mlp({k: w[j] for k, w in params.items()}, xs[j], activation)
             for j in range(len(devices))]
    return col.all_reduce(parts, x.device, axes=("model",), share=share)


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows of ``tokens``. A vocab-sharded table (an M-tuple
    of ``[V/M, d]``) is the reference's ``_sharded_embed_lookup``: shard
    j gathers the rows it owns, zero elsewhere, and the shards' rows add
    over 'model' on the tokens' device."""
    table = params["table"]
    if not isinstance(table, tuple):
        return table[tokens.long()]
    per = table[0].shape[0]
    parts = []
    for i, shard in enumerate(table):
        j = col.shard_start(table) + i          # the logical vocab shard
        local = tokens.long().to(shard.device) - j * per
        ok = (local >= 0) & (local < per)
        rows = shard[local.clamp(0, per - 1)]
        parts.append(rows.masked_fill(~ok[..., None], 0))
    return col.all_reduce(parts, tokens.device, axes=("model",),
                          share=col.shards_share(table))


def lm_logits(params, x: torch.Tensor):
    """Logits in float32: products of the stored-precision operands
    accumulated in f32, as the reference's
    ``preferred_element_type=float32``. A vocab-sharded head (an M-tuple
    of ``[d, V/M]``) gives an M-tuple of logit shards ``[…, V/M]``."""
    w = params["w"]
    if not isinstance(w, tuple):
        return x.float() @ w.float()
    xs = col.broadcast(x, _devices(w), axes=("model",),
                       share=col.shards_share(w))
    return _like(w, (xj.float() @ wj.float() for xj, wj in zip(xs, w)))


def tied_lm_logits(embed_params, x: torch.Tensor):
    """The tied head: logits against the embedding table, ``x @ tableᵀ``
    with f32 accumulation as :func:`lm_logits` (vocab-sharded with the
    table)."""
    table = embed_params["table"]
    if not isinstance(table, tuple):
        return x.float() @ table.float().T
    xs = col.broadcast(x, _devices(table), axes=("model",),
                       share=col.shards_share(table))
    return _like(table, (xj.float() @ tj.float().T
                         for xj, tj in zip(xs, table)))


def token_nll(logits, labels: torch.Tensor) -> torch.Tensor:
    """Each position's ``logsumexp − gold logit`` in f32, on the labels'
    device. Vocab shards (a tuple): the max over every shard (exact),
    each shard's ``Σ exp(logit − max)`` summed over 'model' in f32, the
    gold logit read on the shard that owns the label."""
    if not isinstance(logits, tuple):
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return logz - gold
    dev = labels.device
    devices = _devices(logits)
    per = logits[0].shape[-1]
    with torch.no_grad():
        top = logits[0].amax(dim=-1).to(dev)
        for part in logits[1:]:
            top = torch.maximum(top, part.amax(dim=-1).to(dev))
    tops = [top.to(d) for d in devices]
    sums = [torch.exp(part - t[..., None]).sum(dim=-1)
            for part, t in zip(logits, tops)]
    share = col.shards_share(logits)
    logz = top + torch.log(col.all_reduce(sums, dev, axes=("model",),
                                          share=share))
    golds = []
    for i, part in enumerate(logits):
        j = col.shard_start(logits) + i         # the logical vocab shard
        local = labels.long().to(part.device) - j * per
        ok = (local >= 0) & (local < per)
        g = torch.gather(part, -1, local.clamp(0, per - 1)[..., None])[..., 0]
        golds.append(g.masked_fill(~ok, 0.0))
    return logz - col.all_reduce(golds, dev, axes=("model",), share=share)


def softmax_cross_entropy(
    logits, labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the valid positions, in float32 (the
    reference's logsumexp minus the gold logit; vocab shards as
    :func:`token_nll`). Returns ``(loss, #valid_tokens)``."""
    nll = token_nll(logits, labels)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    total = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / total, total

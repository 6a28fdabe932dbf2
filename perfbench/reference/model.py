"""The plain float32 reference of the benchmarked decoder LMs.

A pre-norm decoder (RMSNorm, per-head q/k RMSNorm, rotary positions on
the two halves of each head, SwiGLU MLP or a routed mixture of experts,
an untied head), written with plain torch operations from the published
description and the benchmark's own configuration file. Where the
system departs from the published model, the reference follows the
system, so that it checks the system's arithmetic; each configuration
file lists the departures under ``assumed``: the token embedding scaled
by √d (both models), and for OLMoE the top-k router probabilities
renormalized, norms at ε 1e-6, per-head q/k norms and each expert
keeping at most 1.25 × its share of a call's rows. It imports nothing
of the program under test: it is handed the same weights the benchmark
made from the seed and works out everything else itself.

Two entries, one per kind of timed path:

* :func:`score_nll` — each token's negative log-likelihood in a batch
  scored whole (and the experts' load-balancing loss; :func:`score_loss`
  their means);
* :func:`serve_logits` — the logits at chosen positions of sequences
  that were served: prompt prefilled in chunks, then decoded.

``precision="fp8"`` is the control: every weight matmul takes operands
rounded to float8 e4m3 (one scale per row of the activations and per
column of the weights), the step below the bf16 the configurations state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from perfbench.reference import energon as E

FP8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class RefConfig:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    eps: float
    experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    dense_layers: int = 2
    pruning_ratio: float = 4.0
    key_block: int = 64
    query_block: int = 128
    page: int = 64
    round_bits: Tuple[int, int] = (2, 4)
    alphas: Tuple[float, float] = (0.0, 0.0)

    @classmethod
    def from_file(cls, spec: Dict) -> "RefConfig":
        """From a configuration file of ``perfbench/configs``."""
        en = spec["energon"]
        return cls(
            layers=spec["num_hidden_layers"], d_model=spec["hidden_size"],
            heads=spec["num_attention_heads"],
            kv_heads=spec["num_key_value_heads"], head_dim=spec["head_dim"],
            d_ff=spec["intermediate_size"],
            vocab=spec["vocab_size"], rope_theta=float(spec["rope_theta"]),
            eps=float(spec["rms_norm_eps"]),
            experts=spec.get("num_experts", 0),
            experts_per_token=spec.get("num_experts_per_tok", 0),
            capacity_factor=float(spec.get("capacity_factor", 1.25)),
            aux_weight=float(spec.get("router_aux_loss_coef", 0.01)),
            dense_layers=en["dense_layers"],
            pruning_ratio=float(en["pruning_ratio"]),
            key_block=en["key_block"], query_block=en["query_block"],
            page=en["decode_key_block"],
            round_bits=tuple(en["round_bits"]), alphas=tuple(en["alphas"]))


class Weights:
    """Float32 views of a weight tree ``{"embed": {"table"}, "final_norm":
    {"scale"}, "lm_head": {"w"}, "blocks": {...: [L, ...]}}``, one layer at
    a time (each leaf converted when it is read)."""

    def __init__(self, tree: Dict):
        self.tree = tree

    def glob(self, group: str, leaf: str) -> torch.Tensor:
        return self.tree[group][leaf].float()

    def layer(self, i: int) -> Dict:
        def take(node):
            return ({k: take(v) for k, v in node.items()}
                    if isinstance(node, dict) else node[i].float())

        return take(self.tree["blocks"])


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = torch.clamp(x.abs().amax(dim, keepdim=True), min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x [..., k] @ w [k, n]`` in float32, or the fp8 control."""
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary positions on ``x [..., n, heads, d]``: each head's first and
    second halves rotate as one complex pair per frequency."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device).float()
                            / d)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.exp(-x))


def qkv(cfg: RefConfig, p, h: torch.Tensor, positions: torch.Tensor,
        precision: str):
    """``h [n, d]`` → q ``[n, H, hd]``, k / v ``[n, KV, hd]``."""
    def proj(w):
        d, nh, hd = w.shape
        return matmul(h, w.reshape(d, nh * hd), precision).reshape(-1, nh, hd)

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"]["scale"], cfg.eps)
        k = rmsnorm(k, p["k_norm"]["scale"], cfg.eps)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attn_out(p, o: torch.Tensor, precision: str) -> torch.Tensor:
    nh, hd, d = p["wo"].shape
    return matmul(o.reshape(-1, nh * hd), p["wo"].reshape(nh * hd, d),
                  precision)


def mlp(p, h: torch.Tensor, precision: str) -> torch.Tensor:
    return matmul(silu(matmul(h, p["w_gate"], precision))
                  * matmul(h, p["w_up"], precision), p["w_down"], precision)


def moe(cfg: RefConfig, p, h: torch.Tensor, precision: str
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts over every row of a call ``h [T, d]``: softmax
    router, the top k (lower expert first among equals) renormalized,
    each expert keeping its first ``capacity`` assignments in (token,
    slot) order; returns the output and the load-balancing loss."""
    t = h.shape[0]
    e, k = cfg.experts, cfg.experts_per_token
    probs = torch.softmax(h @ p["router"], dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    cap = max(1, int(t * k / e * cfg.capacity_factor))
    flat = top_e.reshape(-1)
    onehot = flat[:, None] == torch.arange(e, device=h.device)
    pos = (torch.cumsum(onehot.int(), dim=0) - 1)[torch.arange(
        flat.numel(), device=h.device), flat]
    keep = (pos < cap).reshape(t, k)
    out = torch.zeros_like(h)
    for j in range(e):
        tok, slot = torch.nonzero((top_e == j) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        ex = {n: p[n][j] for n in ("w_up", "w_gate", "w_down")}
        y = mlp(ex, h[tok], precision)
        out.index_add_(0, tok, y * top_p[tok, slot][:, None])
    me = probs.mean(0)
    ce = (top_e[:, :1] == torch.arange(e, device=h.device)).float().mean(0)
    return out, cfg.aux_weight * e * torch.sum(me * ce)


def _ffn(cfg, p, h, precision):
    if cfg.experts:
        return moe(cfg, p["moe"], h, precision)
    return mlp(p["mlp"], h, precision), None


def _head(w: Weights, cfg: RefConfig, precision: str
          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The final norm and the head, the head's weight converted once."""
    scale, head = w.glob("final_norm", "scale"), w.glob("lm_head", "w")
    if precision == "fp8":
        head = _fp8(head, 0)
        return lambda x: _fp8(rmsnorm(x, scale, cfg.eps), -1) @ head
    return lambda x: rmsnorm(x, scale, cfg.eps) @ head


def _embed(w: Weights, cfg: RefConfig, tokens: torch.Tensor) -> torch.Tensor:
    return w.tree["embed"]["table"][tokens.long()].float() * math.sqrt(
        cfg.d_model)


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


def _score_attention(cfg: RefConfig, i: int, q, k, v):
    """``q [n, H, hd]``, ``k, v [n, KV, hd]`` → ``[n, H, hd]``."""
    g = cfg.heads // cfg.kv_heads
    qh = q.transpose(0, 1)
    kh = torch.repeat_interleave(k.transpose(0, 1), g, dim=0)
    vh = torch.repeat_interleave(v.transpose(0, 1), g, dim=0)
    n = q.shape[0]
    sparse = (i >= cfg.dense_layers and n % cfg.query_block == 0
              and n % cfg.key_block == 0 and n // cfg.key_block > 1)
    if not sparse:
        return E.dense_causal(qh, kh, vh).transpose(0, 1)
    return E.score_attention(
        qh, kh, vh, bq=cfg.query_block, bk=cfg.key_block,
        rho=cfg.pruning_ratio, round_bits=cfg.round_bits,
        alphas=cfg.alphas).transpose(0, 1)


def score_nll(cfg: RefConfig, w: Weights, inputs: torch.Tensor,
              targets: torch.Tensor, precision: str = "f32",
              rows: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each position's negative log-likelihood ``[B, n]`` of ``targets``
    given ``inputs [B, n]``, and the experts' load-balancing loss summed
    over layers (0 without experts)."""
    b, n = inputs.shape
    pos = torch.arange(n, device=inputs.device)
    x = _embed(w, cfg, inputs)                            # [B, n, d]
    aux = torch.zeros((), device=inputs.device)
    for i in range(cfg.layers):
        p = w.layer(i)
        for s in range(b):
            h = rmsnorm(x[s], p["norm_attn"]["scale"], cfg.eps)
            q, k, v = qkv(cfg, p["attn"], h, pos, precision)
            x[s] += attn_out(p["attn"], _score_attention(cfg, i, q, k, v),
                             precision)
        h = rmsnorm(x, p["norm_mlp"]["scale"], cfg.eps).reshape(b * n, -1)
        y, a = _ffn(cfg, p, h, precision)
        x += y.reshape(b, n, -1)
        if a is not None:
            aux = aux + a
        del p
    flat, tgt = x.reshape(b * n, -1), targets.reshape(-1).long()
    nll = torch.empty(b * n, device=inputs.device)
    head = _head(w, cfg, precision)
    for s in range(0, b * n, rows):
        logits = head(flat[s:s + rows])
        nll[s:s + rows] = (torch.logsumexp(logits, -1)
                           - logits.gather(-1, tgt[s:s + rows, None])[:, 0])
    return nll.reshape(b, n), aux


def score_loss(cfg: RefConfig, w: Weights, inputs: torch.Tensor,
               targets: torch.Tensor, precision: str = "f32"
               ) -> Dict[str, float]:
    """The mean cross-entropy (``ce``), the load-balancing loss (``aux``)
    and their sum (``loss``), as floats."""
    nll, aux = score_nll(cfg, w, inputs, targets, precision)
    ce = float(nll.double().mean())
    return {"ce": ce, "aux": float(aux), "loss": ce + float(aux)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Served:
    """One served sequence: the prompt, the tokens served after it, and
    the engine shape it was served at."""

    prompt: Sequence[int]
    served: Sequence[int]


def serve_logits(cfg: RefConfig, w: Weights, seqs: List[Served], *,
                 chunk: int, cache_rows: int, device,
                 precision: str = "f32") -> List[torch.Tensor]:
    """For each sequence, the logits ``[len(served), V]`` that predicted
    its served tokens (positions P − 1 .. P + T − 2), the prompt
    prefilled in chunks of ``chunk`` rows and the rest decoded one
    position at a time over a cache of ``cache_rows`` rows."""
    if cfg.experts:
        raise NotImplementedError("served experts are not in the reference")
    toks = [torch.as_tensor(list(s.prompt) + list(s.served)[:-1],
                            device=device) for s in seqs]
    xs = [_embed(w, cfg, t) for t in toks]
    for i in range(cfg.layers):
        p = w.layer(i)
        for j, (s, x) in enumerate(zip(seqs, xs)):
            n = x.shape[0]
            pos = torch.arange(n, device=device)
            h = rmsnorm(x, p["norm_attn"]["scale"], cfg.eps)
            q, k, v = qkv(cfg, p["attn"], h, pos, precision)
            if i < cfg.dense_layers:
                g = cfg.heads // cfg.kv_heads
                o = E.dense_causal(
                    q.transpose(0, 1),
                    torch.repeat_interleave(k.transpose(0, 1), g, dim=0),
                    torch.repeat_interleave(v.transpose(0, 1), g, dim=0),
                ).transpose(0, 1)
            else:
                o = E.serve_attention(
                    q, k, v, prefill=len(s.prompt), chunk=chunk,
                    cache_rows=cache_rows, bq=cfg.query_block, bk=cfg.page,
                    rho=cfg.pruning_ratio, round_bits=cfg.round_bits,
                    alphas=cfg.alphas)
            x = x + attn_out(p["attn"], o, precision)
            y, _ = _ffn(cfg, p, rmsnorm(x, p["norm_mlp"]["scale"], cfg.eps),
                        precision)
            xs[j] = x + y
        del p
    out = []
    head = _head(w, cfg, precision)
    for s, x in zip(seqs, xs):
        first = len(s.prompt) - 1
        out.append(head(x[first:first + len(s.served)]))
    return out


def token_gaps(logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """How far each given token's logit lies below the best at its
    position: ``logits [T, V]``, ``tokens [T]`` → ``[T]``."""
    t = torch.as_tensor(list(tokens), device=logits.device).long()
    return logits.amax(-1) - logits.gather(-1, t[:, None])[:, 0]


class exact_float32:
    """Float32 matmuls at full precision (no TF32, no reduced-precision
    reductions) and no autograd, restored on exit."""

    def __enter__(self):
        b = torch.backends.cuda.matmul
        self.saved = (b.allow_tf32, torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision(),
                      b.allow_bf16_reduced_precision_reduction)
        b.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        b.allow_bf16_reduced_precision_reduction = False
        self.mode = torch.inference_mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        b = torch.backends.cuda.matmul
        (b.allow_tf32, torch.backends.cudnn.allow_tf32, prec,
         b.allow_bf16_reduced_precision_reduction) = self.saved
        torch.set_float32_matmul_precision(prec)
        return False

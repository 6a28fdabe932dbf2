"""The least work of a whole model step, for the ``*_mfu`` metrics.

Counted from the configuration file and the harness's own bookkeeping
(cache lengths, chunk rows, batch shapes): the weight matmuls each token
needs (its k experts in a mixture), the attention the dense leading
layers need over the causal keys, the sparse layers' filter and, where
the harness can count it, their gather; the weights read once per step.
What depends on a selection the harness cannot see is left out, so every
count is a lower bound of the work and a share of the peak stays a share.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from perfbench.work import kernels as K
from perfbench.work.peaks import HBM_BYTES_S, PEAK_BF16, PEAK_INT8


def _dims(spec: Dict):
    return (spec["hidden_size"], spec["num_hidden_layers"],
            spec["num_attention_heads"], spec["num_key_value_heads"],
            spec["head_dim"], spec["intermediate_size"], spec["vocab_size"])


def layer_params(spec: Dict) -> Tuple[int, int]:
    """Per layer: the matmul weights one token uses, and all there are
    (every expert of a mixture)."""
    d, _, h, kv, hd, f, _ = _dims(spec)
    attn = d * (h + 2 * kv) * hd + h * hd * d
    e = spec.get("num_experts", 0)
    if e:
        k = spec["num_experts_per_tok"]
        return attn + d * e + k * 3 * d * f, attn + d * e + e * 3 * d * f
    return attn + 3 * d * f, attn + 3 * d * f


def head_params(spec: Dict) -> int:
    return spec["hidden_size"] * spec["vocab_size"]


def weight_bytes(spec: Dict, itemsize: int = 2) -> int:
    """Every matmul weight once, in the served dtype."""
    _, total = layer_params(spec)
    return (spec["num_hidden_layers"] * total + head_params(spec)) * itemsize


def score_flops(spec: Dict, seqs: int, n: int) -> float:
    """bf16 FLOPs a scoring call of ``seqs × n`` tokens needs: the weight
    matmuls and the head for every token, and the dense leading layers'
    causal attention (the sparse layers' attention is left out)."""
    d, L, h, kv, hd, f, v = _dims(spec)
    used, _ = layer_params(spec)
    tokens = seqs * n
    dense = spec["energon"]["dense_layers"]
    attn = dense * seqs * h * K.causal_pairs(n) * hd * 4
    return 2.0 * tokens * (L * used + head_params(spec)) + attn


def step_bound_s(flops: float, int8_ops: float, nbytes: float) -> float:
    """The least time of a step: its compute at the peaks, or its bytes
    at the HBM rate, whichever is longer."""
    return max(flops / PEAK_BF16 + int8_ops / PEAK_INT8,
               nbytes / HBM_BYTES_S)


def decode_step(spec: Dict, lengths: List[int]) -> Tuple[float, float, float]:
    """``(bf16 FLOPs, int8 ops, bytes)`` of one decode step over slots at
    cache ``lengths`` (after the step's append)."""
    d, L, h, kv, hd, f, v = _dims(spec)
    en = spec["energon"]
    dense = en["dense_layers"]
    g, bk, rho = h // kv, en["decode_key_block"], en["pruning_ratio"]
    used, _ = layer_params(spec)
    n = len(lengths)
    flops = 2.0 * n * (L * used + head_params(spec))
    flops += dense * sum(lengths) * h * hd * 4
    nbytes = weight_bytes(spec) + dense * sum(lengths) * kv * hd * 2 * 2
    filt = K.decode_filter(lengths, kv, g, hd, bk)
    gath = K.decode_gather(lengths, kv, g, hd, bk, rho)
    flops += (L - dense) * gath[1]
    nbytes += (L - dense) * (filt[0] + gath[0])
    return flops, (L - dense) * filt[1], nbytes


def prefill_wave(spec: Dict, chunks: List[Tuple[int, int]],
                 finishing: int, chunk: int) -> Tuple[float, float, float]:
    """``(bf16 FLOPs, int8 ops, bytes)`` of one prefill wave over the
    chunks ``(start, end)``, ``finishing`` of which end their prompts
    (and need the head on their last row)."""
    d, L, h, kv, hd, f, v = _dims(spec)
    en = spec["energon"]
    dense = en["dense_layers"]
    g = h // kv
    used, _ = layer_params(spec)
    rows = sum(e - s for s, e in chunks)
    pairs = sum((s + e + 1) * (e - s) // 2 for s, e in chunks)
    flops = 2.0 * (rows * L * used + finishing * head_params(spec))
    flops += dense * pairs * h * hd * 4
    head = 0 if finishing else head_params(spec) * 2
    nbytes = (weight_bytes(spec) - head
              + dense * sum(e for _, e in chunks) * kv * hd * 2 * 2)
    filt = K.prefill_filter(chunks, kv, g, hd, en["query_block"],
                            en["decode_key_block"], chunk)
    nbytes += (L - dense) * filt[0]
    return flops, (L - dense) * filt[1], nbytes

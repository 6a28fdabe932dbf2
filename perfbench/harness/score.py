"""Scoring cells: each token's log-likelihood under the model, over batches
of long sequences, back to back.

A call is ``LMModel.apply`` over a batch (the logits in float32) and each
position's negative log-likelihood of the next token taken from them one
sequence at a time: what a perplexity evaluation needs per document, and
the same work as ``LMModel.loss`` but its mean. Set-up makes the weights
from the seed and makes one call at the cell's shape. The window starts
the first call and closes at the end of the call running when
``--seconds`` have passed; every call's tokens are made on the device
from the seed and the call's index. The check draws one finished call
from the seed, frees the program, re-makes the weights and that call's
tokens, and holds every one of its tokens' log-likelihoods against the
float32 reference's.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

from perfbench.harness import port, traffic, weights
from perfbench.harness.record import CallRecord, Run
from perfbench.harness.trace import Tracer, span
from perfbench.harness.verdict import verdict

WARMUP_CALL = -1


def token_nll(logits, targets):
    """``logsumexp − gold`` of ``logits [B, n, V]`` at ``targets [B, n]``,
    one sequence at a time (so the temporary is one sequence's)."""
    import torch

    out = torch.empty(targets.shape, device=logits.device)
    for s in range(logits.shape[0]):
        lg = logits[s]
        out[s] = torch.logsumexp(lg, -1) - lg.gather(
            -1, targets[s].long()[:, None])[:, 0]
    return out


def run(spec: Dict, mix: Dict, limits: Dict, *, seed: int, seconds: float,
        trace: bool, device, t_start: float,
        smoke_layers: Optional[int] = None, control: bool = False) -> Dict:
    """One run of a scoring cell. ``control`` (never set by the
    benchmark's own runs) also reads the fp8 control's numbers."""
    import torch

    from repro_torch.models import LMModel

    cfg = port.model_config(spec, smoke_layers)
    if smoke_layers is not None:
        spec = port.smoke_spec(cfg, spec["registry"])
    dtype = getattr(torch, cfg.dtype)
    vocab = spec["vocab_size"]
    tree = weights.make(spec, seed, device, dtype)
    model = LMModel(cfg, device=device)

    def call(i):
        with span("perfbench.batch"):
            toks = traffic.score_tokens(mix, seed, i, vocab, device)
        with span("perfbench.apply"), torch.inference_mode():
            logits, _ = model.apply(tree, {"inputs": toks[:, :-1]})
            nll = token_nll(logits, toks[:, 1:])
            del logits
            return nll.cpu()

    call(WARMUP_CALL)
    rec = Run(kind="score", spec=spec, mix=mix, seconds=seconds)
    rec.setup_s = time.perf_counter() - t_start
    tokens = mix["batch"] * mix["seq_len"]
    tr = mix["trace"]
    tracer = Tracer(device) if trace else None
    answers = []
    t0 = time.perf_counter()
    i = 0
    while True:
        traced = tracer is not None and tr["skip_calls"] <= i < (
            tr["skip_calls"] + tr["calls"])
        if traced and not tracer.active:
            tracer.start()
        s = time.perf_counter()
        answers.append(call(i))
        e = time.perf_counter()
        rec.calls.append(CallRecord(start=s, end=e, tokens=tokens))
        if traced:
            rec.traced_calls.append(rec.calls[-1])
            if i == tr["skip_calls"] + tr["calls"] - 1:
                tracer.stop()
        i += 1
        if e - t0 >= seconds and (tracer is None or not tracer.active):
            break
    rec.window = (t0, rec.calls[-1].end)
    if tracer is not None and tracer.done:
        tracer.reduce()
    rec.tracer = tracer
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    pick = int(traffic.rng_for(seed, traffic.TRAFFIC_STREAM + 98).integers(
        len(answers)))
    del model, tree
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref, low = reference_nll(spec, mix, seed, pick, device, dtype,
                             control=control)
    numbers = nll_numbers(answers[pick] - ref)
    checks, correct = verdict(numbers, limits)
    out = dict(run=rec, correct=correct, attempted=len(answers), failed=0,
               memory_peak_bytes=int(peak), checks=checks, numbers=numbers)
    if control:
        out["control"] = nll_numbers(low - ref)
        out["control_checks"], out["control_correct"] = verdict(
            out["control"], limits)
    return out


def nll_numbers(diff) -> Dict[str, float]:
    """What the check can compare of the per-token log-likelihood
    differences from the reference: the largest, the mean absolute one,
    and their mean square (which grows with the square of the logits'
    error)."""
    d = diff.double()
    return {"nll_gap": float(d.abs().max()),
            "nll_mean_gap": float(d.abs().mean()),
            "nll_mean_sq": float((d * d).mean())}


def reference_nll(spec: Dict, mix: Dict, seed: int, call: int, device,
                  dtype, control: bool = False):
    """The reference's per-token NLL ``[B, n]`` (on the host) for call
    ``call`` of ``seed``, and with ``control`` the fp8 control's (else
    None)."""
    from perfbench.reference import model as R

    rc, low = R.RefConfig.from_file(spec), None
    with R.exact_float32():
        tree = weights.make(spec, seed, device, dtype)
        toks = traffic.score_tokens(mix, seed, call, spec["vocab_size"],
                                    device)
        args = (rc, R.Weights(tree), toks[:, :-1], toks[:, 1:])
        ref = R.score_nll(*args)[0].cpu()
        if control:
            low = R.score_nll(*args, precision="fp8")[0].cpu()
        del tree
    return ref, low

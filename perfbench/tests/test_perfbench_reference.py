"""The float32 reference agrees with the port at smoke widths on the CPU:
scoring (the direct and the chunked route, dense and MoE; the loss and
each token's NLL) to the last bits, and every greedy token the paged
engine serves (prefix sharing, chunked prefill, decode) is the
reference's best at its position."""

import dataclasses

import _perfbench_paths  # noqa: F401
import numpy as np
import pytest
import torch

from perfbench.harness import port, weights
from perfbench.reference import model as R

LAYERS = 4


def _setup(arch, chunk_threshold=None, seed=123):
    from repro_torch.configs import registry
    from repro_torch.models import LMModel

    cfg = dataclasses.replace(registry.get_serve_config(arch, smoke=True),
                              num_layers=LAYERS)
    if chunk_threshold is not None:
        cfg = dataclasses.replace(cfg, energon=dataclasses.replace(
            cfg.energon, chunk_threshold=chunk_threshold))
    spec = port.smoke_spec(cfg, arch)
    tree = weights.make(spec, seed, torch.device("cpu"), torch.float32)
    model = LMModel(cfg, device="cpu")
    assert weights.shapes(tree) == model.param_shapes()
    return cfg, spec, tree, model


@pytest.mark.parametrize("arch,threshold", [
    ("qwen3-14b", None), ("qwen3-14b", 1000), ("olmoe-1b-7b", 1000)])
def test_score_loss_matches_the_port(arch, threshold):
    cfg, spec, tree, model = _setup(arch, threshold)
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (3, 65), generator=g)
    with torch.no_grad():
        loss, m = model.loss(tree, {"inputs": toks[:, :-1],
                                    "targets": toks[:, 1:]})
        ref = R.score_loss(R.RefConfig.from_file(spec), R.Weights(tree),
                           toks[:, :-1], toks[:, 1:])
    assert ref["ce"] == pytest.approx(float(m["ce"]), abs=2e-6)
    assert ref["aux"] == pytest.approx(float(m["aux"]), abs=2e-6)
    assert ref["loss"] == pytest.approx(float(loss), abs=2e-6)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_served_tokens_are_the_references_best(chunk):
    from repro_torch.runtime import Request, ServeLoop

    cfg, spec, tree, model = _setup("qwen3-14b")
    eng = ServeLoop(model, tree, batch_slots=4, max_len=256, eos_token=-1,
                    seed=1, prefill_chunk=chunk, prefix_sharing=True,
                    device="cpu")
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, 32).tolist()
    reqs = []
    for i in range(6):
        body = rng.integers(0, cfg.vocab_size, int(rng.integers(5, 60)))
        reqs.append(Request(uid=i, prompt=system + body.tolist(),
                            max_new_tokens=int(rng.integers(10, 40))))
        eng.submit(reqs[-1])
        eng.tick()
    eng.run_until_drained()
    assert eng.metrics.prefill_tokens_skipped > 0
    seqs = [R.Served(r.prompt, r.tokens_out) for r in reqs]
    with torch.no_grad():
        logits = R.serve_logits(R.RefConfig.from_file(spec), R.Weights(tree),
                                seqs, chunk=chunk, cache_rows=eng.max_len,
                                device="cpu")
    for r, lg in zip(reqs, logits):
        assert lg.shape == (len(r.tokens_out), cfg.vocab_size)
        assert float(R.token_gaps(lg, r.tokens_out).max()) < 1e-4


def test_token_nll_matches_the_port_apply():
    from perfbench.harness.score import token_nll

    cfg, spec, tree, model = _setup("olmoe-1b-7b", 1000)
    g = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=g)
    with torch.no_grad():
        logits, _ = model.apply(tree, {"inputs": toks[:, :-1]})
        nll = token_nll(logits, toks[:, 1:])
        ref, _ = R.score_nll(R.RefConfig.from_file(spec), R.Weights(tree),
                             toks[:, :-1], toks[:, 1:])
    assert float((nll - ref).abs().max()) < 1e-4

"""A run whose timed path is broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at smoke widths (the
harness's look for a card skipped) with the cell's own limits: sound; with
the fp8 control read beside the program (the rule that decides
``correct`` must judge it not correct); and
with each fault the cell can have: a served token altered
where it is produced, serving steps that leave the cache as it was,
half of a scored batch left out (its rows filled from the rest), a
scored answer altered where it is produced.
"""

import time

import _perfbench_paths  # noqa: F401
import pytest
import torch

from perfbench.harness import bench, score, serve

SERVE = "qwen3-14b.serve-chat"
SESSIONS = "qwen3-14b.serve-longctx"
SCORE = "qwen3-14b.score-8k"
LAYERS = 12


def _serve_mix(cell):
    mix = dict(cell.mix)
    # short prompts and long answers: most keys a decode step reads are
    # rows earlier decode steps wrote
    mix.update(preroll_s=1.0, grace_s=10,
               engine=dict(batch_slots=4, max_len=256, prefill_chunk=16,
                           scheduler="hybrid", prefix_sharing=True),
               check=dict(min_served_tokens=60, max_requests=4))
    if mix["loop"] == "closed":
        mix.update(sessions=3, document=96, turns=4,
                   question=dict(dist="uniform", min=4, max=12),
                   answer=dict(dist="uniform", min=20, max=40))
    else:
        mix.update(rate_per_s=3.0, shared_prefix=16,
                   prompt=dict(dist="lognormal", median=8, sigma=0.4, min=4,
                               max=16),
                   output=dict(dist="lognormal", median=60, sigma=0.3,
                               min=40, max=100))
    return mix


def _serve(monkeypatch, fault=None, layers=LAYERS, control=False,
           name=SERVE):
    torch.set_num_threads(2)
    cell = bench.Cell(name)
    limits = dict(cell.limits, tokens_checked=20)
    if fault == "token":
        from repro_torch.runtime.serve_loop import ServeLoop

        real = ServeLoop._commit_token

        def altered(self, i, req, tok):
            if req.temperature == 0.0 and len(req.tokens_out) == 3:
                tok = (tok + 1) % self.model.cfg.vocab_size
            return real(self, i, req, tok)

        monkeypatch.setattr(ServeLoop, "_commit_token", altered)
    elif fault == "state":
        from repro_torch.models import attention

        def unchanged(cache, k, v, write, chunk, ps):
            return None               # the step writes no K/V row

        monkeypatch.setattr(attention, "_write_pool", unchanged)
    mix = _serve_mix(cell)
    if control:
        # a mean over a few dozen tokens swings with which ones flip
        mix["check"] = dict(min_served_tokens=200, max_requests=8)
    return serve.run(cell.config, mix, limits, seed=2 ** 31 + 5,
                     seconds=3.0, trace=False, device=torch.device("cpu"),
                     t_start=time.perf_counter(), smoke_layers=layers,
                     control=control)


def _score(monkeypatch, fault=None, layers=LAYERS, control=False):
    from repro_torch.models.model import LMModel

    torch.set_num_threads(2)
    cell = bench.Cell(SCORE)
    real = LMModel.apply
    if fault == "half":
        def half(self, params, batch, mesh=None):
            b = batch["inputs"].shape[0] // 2
            logits, aux = real(self, params, {"inputs": batch["inputs"][:b]})
            return torch.cat([logits, logits]), aux

        monkeypatch.setattr(LMModel, "apply", half)
    elif fault == "answer":
        def altered(self, params, batch, mesh=None):
            logits, aux = real(self, params, batch)
            logits[0, 5, batch["inputs"][0, 6]] += 1.0
            return logits, aux

        monkeypatch.setattr(LMModel, "apply", altered)
    mix = dict(cell.mix, batch=4, seq_len=64)
    return score.run(cell.config, mix, cell.limits, seed=2 ** 31 + 6,
                     seconds=0.5, trace=False, device=torch.device("cpu"),
                     t_start=time.perf_counter(), smoke_layers=layers,
                     control=control)


@pytest.mark.parametrize("name", [SERVE, SESSIONS])
def test_sound_serving_run_is_correct(monkeypatch, name):
    out = _serve(monkeypatch, name=name)
    assert out["correct"], out["checks"]
    assert out["checks"]["mean_gap"]["value"] < 1e-6


@pytest.mark.parametrize("name", [SERVE, SESSIONS])
@pytest.mark.parametrize("fault", ["token", "state"])
def test_broken_serving_run_is_not_correct(monkeypatch, fault, name):
    out = _serve(monkeypatch, fault, name=name)
    assert not out["correct"], out["checks"]


def test_sound_scoring_run_is_correct(monkeypatch):
    out = _score(monkeypatch)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["half", "answer"])
def test_broken_scoring_run_is_not_correct(monkeypatch, fault):
    out = _score(monkeypatch, fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", [SERVE, SESSIONS])
def test_control_fails_the_serving_limit(monkeypatch, name):
    out = _serve(monkeypatch, layers=4, control=True, name=name)
    assert out["correct"]
    # the rule that decides ``correct`` judges the control not correct
    assert not out["control_correct"], out["control_checks"]
    limit = out["checks"]["mean_gap"]["max"]
    assert out["control_checks"]["mean_gap"] == {
        "value": out["control"]["mean_gap"], "max": limit}
    assert out["control"]["mean_gap"] > limit


def test_control_fails_the_scoring_limit(monkeypatch):
    out = _score(monkeypatch, layers=4, control=True)
    assert out["correct"]
    assert not out["control_correct"], out["control_checks"]
    limit = out["checks"]["nll_mean_sq"]["max"]
    assert out["control"]["nll_mean_sq"] > 2 * limit

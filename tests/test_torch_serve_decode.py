"""``python -m repro_torch.serve_decode``, the port of the reference's
``examples/serve_decode.py``, against the reference's own scenario.

The reference's run is built here from ``src/repro``'s modules as the
example builds it (its config, ``init(PRNGKey(0))``, the 8-slot pool of
20 pages, the numpy request stream of seed 0, ``Observability`` on) and
drained; the port's ``main(device="cpu")`` serves the same requests on
the same weights (carried across by ``convert``) in a temporary working
directory, where it writes ``serve_trace.json``. Every request's tokens
— the greedy and the stochastic, drawn from the reference's Threefry
streams — must be equal. The two runs' traces are equal event for event
(admissions, prefix skips, chunks, ticks, evictions, preemptions) until
the first re-admission of a preempted request that had decoded: there
the port replays the decode steps that wrote its rows, where the
reference re-prefills them (a deliberate difference, ROADMAP §C), so
from there ticks, calls, preemptions, prefix hits and ρ_eff differ;
the peak of pages, the decoded tokens and the CoW clones stay equal.
Latencies, stragglers and tok/s are the host's and are not compared.
"""

import collections
import json

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import EnergonConfig as JaxEnergonConfig
from repro.models import LMModel as JaxLMModel
from repro.observability import Observability as JaxObservability
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch import serve_decode
from repro_torch.convert import convert_params
from repro_torch.models import LMModel


@pytest.fixture(scope="module")
def reference():
    """The reference example's scenario, run from its modules."""
    cfg = JaxModelConfig(
        name="serve-demo", family="dense", num_layers=4, d_model=128,
        num_heads=8, num_kv_heads=4, head_dim=16, d_ff=256,
        vocab_size=512, dtype="float32", remat="none",
        energon=JaxEnergonConfig(impl="mpmrf_block", min_prune_layer=1,
                                 pruning_ratio=2.0, decode_key_block=32),
    )
    model = JaxLMModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    obs = JaxObservability()
    engine = JaxServeLoop(model, params, batch_slots=8, max_len=160,
                          eos_token=cfg.vocab_size - 1, prefill_chunk=16,
                          num_pages=20, observability=obs)
    for r in serve_decode.request_stream(serve_decode.config()):
        engine.submit(JaxRequest(**r))
    done = engine.run_until_drained()
    return dict(params=params, done=done, engine=engine, obs=obs)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    model = LMModel(serve_decode.config(), device="cpu")
    params = convert_params(jax.tree.map(np.asarray, reference["params"]),
                            model)
    cwd = tmp_path_factory.mktemp("serve_decode")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        out = serve_decode.main(device="cpu", params=params,
                                log=lambda line: None)
    out["trace_file"] = cwd / "serve_trace.json"
    return out


def _streams(done):
    return {r.uid: list(r.tokens_out) for r in done}


def test_every_stream_equals_the_reference(reference, port):
    want, got = _streams(reference["done"]), _streams(port["done"])
    assert len(got) == serve_decode.N_REQUESTS
    assert got == want
    assert sum(len(t) for t in got.values()) == 24 * 24


#: counts the restore of a decoded request does not move
SAME = ("peak_pages_in_use", "decode_tokens", "cow_clones")


@pytest.mark.parametrize("name", SAME)
def test_counts_equal_the_reference(reference, port, name):
    got = getattr(port["engine"].metrics, name)
    assert got == getattr(reference["engine"].metrics, name)


def _signature(obs, upto):
    """The trace's events up to tick ``upto``, without the host's
    clock."""
    return [(e.name, e.tick, e.slot, e.uid, e.site, e.args)
            for e in obs.trace.events if e.tick <= upto]


def _first_decoded_restore(obs):
    """The tick at which a request that had sampled tokens (``resumed``)
    is admitted again."""
    return next(e.tick for e in obs.trace.events
                if e.name == "admit" and e.args["resumed"])


def test_the_runs_part_only_where_a_decoded_request_is_restored(
        reference, port):
    """The two traces are the same event for event — admissions and
    their prefix skips, prefill chunks, decode ticks, page evictions,
    preemptions, the pool's series — up to the tick that re-admits the
    first preempted request that had decoded (uid 7, tick 17), and that
    tick's admissions too. From there the port restores the rows its
    decode wrote by replaying those decode steps (bit for bit, ROADMAP
    §C) where the reference re-prefills them, so the schedules part
    while the streams stay equal: ticks, calls, preemptions, prefix hits
    and ρ_eff then differ, by design."""
    want, got = reference["obs"], port["obs"]
    tick = _first_decoded_restore(want)
    assert tick == _first_decoded_restore(got) > 0
    assert _signature(got, tick - 1) == _signature(want, tick - 1)

    def admits(obs):
        return [sig for sig in _signature(obs, tick)
                if sig[0] == "admit" and sig[1] == tick]

    assert admits(got) == admits(want)
    assert got.trace.dropped == want.trace.dropped == 0
    engine = port["engine"].metrics
    assert engine.preemptions > 0 and engine.prefix_hits > 0
    sp = got.sparsity.snapshot()
    assert 0.0 < sp["decode"]["rho_eff"] <= 1.0
    assert sp["prefill"]["rho_eff"] is None
    assert want.sparsity.snapshot()["prefill"]["rho_eff"] is None
    with open(port["trace_file"]) as f:
        trace = json.load(f)
    names = collections.Counter(e.name for e in got.trace.events)
    assert len(trace["traceEvents"]) >= sum(names.values())
    assert names["finish"] == serve_decode.N_REQUESTS


def test_main_prints_the_reference_lines(port):
    lines = port["lines"]
    assert lines[0].startswith("[serve] 24/24 requests, 576 tokens in ")
    assert lines[-1] == ("[obs] chrome trace -> serve_trace.json "
                         "(open in ui.perfetto.dev)")
    assert [line.split(" ")[0] for line in lines] == ["[serve]"] * 5 + [
        "[obs]"] * 3

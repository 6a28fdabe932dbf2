"""Device sparsity telemetry through the port's model and engine, on the
fp32 qwen3-14b serve-smoke config (impl pallas, pages of 16, query
block 16, chunks of 8; layers 0–1 are the dense prefix, layer 2
sparse), weights carried
from the reference by ``repro_torch.convert``.

* ``LMModel.prefill`` / ``decode_step`` with ``telemetry=True`` return
  the reference ``LMModel``'s ``[L, B, 4]`` selection counts exactly
  (int32), paged and unpaged, and logits and cache bit for bit as with
  ``telemetry=False``.
* The telemetry steps pass ``test_torch_graph.py``'s dispatch guard
  (no host sync, no data-dependent shape), so they can be captured.
* Through ``ServeLoop``: ρ_eff is recorded end to end; telemetry never
  changes a stream; an engine without observability dispatches the
  plain steps and emits nothing; ``device_telemetry=False`` keeps the
  events and builds no telemetry step.

The selection is integer-exact on the same codes; the two packages'
fp32 projections sum in other orders, so each step starts both models
from the same cache (the reference's, copied into the port's) and the
same tokens, and logits are held at the model tests' 1e-4."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LMModel as JaxLMModel
from repro_torch.configs.registry import get_serve_config
from repro_torch.convert import convert_params
from repro_torch.models import LMModel
from repro_torch.observability import Observability
from repro_torch.runtime import Request, ServeLoop
from tests._torch_port import jax_model_config, n, t
from tests.test_torch_graph import HostSyncGuard, _filled

MAX_LEN, CHUNK, PAGES, SLOTS = 64, 8, 12, 3
TOL = dict(atol=1e-4, rtol=1e-4)
TABLE = np.array([[3, 0, 5, 1], [2, 7, 4, 6], [8, 9, 10, 11]], np.int32)


@pytest.fixture(scope="module")
def models():
    cfg = get_serve_config("qwen3-14b", smoke=True)
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return cfg, jmodel, jparams, model, params


def _load(cache, jcache):
    """The reference cache's values into the port's leaves, in place."""
    for k, v in jcache.items():
        cache[k].copy_(t(v))


def _snapshot(cache):
    return {k: v.clone() for k, v in cache.items()}


def _port_step(model, method, params, cache, inputs, index):
    """The step with and without telemetry from one cache state: returns
    the telemetry call's (logits, cache, stats) and asserts the plain
    call's logits and cache are the same bits."""
    before = _snapshot(cache)
    logits, _ = getattr(model, method)(params, cache, inputs, index)
    plain = _snapshot(cache)
    for k, v in before.items():
        cache[k].copy_(v)
    out, _, stats = getattr(model, method)(params, cache, inputs, index,
                                           telemetry=True)
    assert torch.equal(out, logits)
    for k in cache:
        assert torch.equal(cache[k], plain[k]), k
    assert stats.dtype == torch.int32
    assert stats.shape == (model.cfg.num_layers, inputs["tokens"].shape[0], 4)
    return out, stats


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_stats_equal_the_reference_and_change_no_bit(models, paged):
    cfg, jmodel, jparams, model, params = models
    if paged:
        jcache = jmodel.init_paged_cache(PAGES, max_len=MAX_LEN)
        cache = model.init_paged_cache(PAGES, max_len=MAX_LEN)
        extra = {"block_table": TABLE}
    else:
        jcache = jmodel.init_cache(SLOTS, MAX_LEN)
        cache = model.init_cache(SLOTS, MAX_LEN)
        extra = {}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size - 1, size=L)
               for L in (29, 17, 0)]               # slot 2 stays idle
    zero = np.zeros(SLOTS, np.int32)
    seen = np.zeros(4, np.int64)
    for c in range(4):
        toks = np.zeros((SLOTS, CHUNK), np.int32)
        pos = np.full((SLOTS, CHUNK), MAX_LEN, np.int32)
        for b, p in enumerate(prompts):
            part = p[c * CHUNK:(c + 1) * CHUNK]
            toks[b, :len(part)] = part
            pos[b, :len(part)] = c * CHUNK + np.arange(len(part))
        inputs = {"tokens": toks, "positions": pos, **extra}
        _load(cache, jcache)
        ref, jcache, jstats = jmodel.prefill(
            jparams, jcache, {k: jnp.asarray(v) for k, v in inputs.items()},
            jnp.asarray(zero), telemetry=True)
        out, stats = _port_step(model, "prefill", params, cache,
                                {k: t(v) for k, v in inputs.items()}, t(zero))
        np.testing.assert_array_equal(n(stats), np.asarray(jstats))
        real = pos < MAX_LEN
        np.testing.assert_allclose(n(out)[real], np.asarray(ref)[real], **TOL)
        assert not n(stats)[:2].any()              # the dense prefix
        seen += n(stats).sum((0, 1))

    idx = np.array([len(p) for p in prompts], np.int32)
    nxt = np.array([[5], [9], [0]], np.int32)
    active = np.array([True, True, False])
    for step in range(4):
        inputs = {"tokens": nxt, "active": active, **extra}
        index = idx if paged else np.where(active, idx, MAX_LEN)
        _load(cache, jcache)
        ref, jcache, jstats = jmodel.decode_step(
            jparams, jcache, {k: jnp.asarray(v) for k, v in inputs.items()},
            jnp.asarray(index), telemetry=True)
        out, stats = _port_step(model, "decode_step", params, cache,
                                {k: t(v) for k, v in inputs.items()},
                                t(index))
        np.testing.assert_array_equal(n(stats), np.asarray(jstats))
        np.testing.assert_allclose(n(out)[active], np.asarray(ref)[active],
                                   **TOL)
        seen += n(stats)[:, active].sum((0, 1))
        nxt = np.asarray(ref[:, -1].argmax(-1), np.int32)[:, None]
        idx = idx + active
    # the counts are not all trivial: blocks were pruned, pinned and live
    selected, live, pinned, _ = seen
    assert 0 < selected < live and pinned > 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
@pytest.mark.parametrize("method", ["decode_step", "prefill"])
def test_telemetry_steps_make_no_host_sync(models, paged, method):
    model, params = models[3], models[4]
    cache, pre, zero, dec, index = _filled(model, params, paged)
    inputs, idx = (dec, index) if method == "decode_step" else (pre, zero)
    with HostSyncGuard() as guard:
        logits, _, stats = getattr(model, method)(params, cache, inputs, idx,
                                                  telemetry=True)
    assert guard.seen == []
    assert torch.isfinite(logits).all() and stats[2:].sum() > 0


def _trace(cfg, n_req=5, seed=7):
    rng = np.random.default_rng(seed)
    prefix = [int(x) for x in rng.integers(1, cfg.vocab_size - 1, size=16)]
    return [dict(uid=uid, prompt=prefix + [int(x) for x in rng.integers(
                     1, cfg.vocab_size - 1, size=int(rng.integers(3, 20)))],
                 max_new_tokens=6, temperature=0.9 if uid % 2 else 0.0)
            for uid in range(n_req)]


def _serve(models, observability=None, **kw):
    cfg, _, _, model, params = models
    engine = ServeLoop(model, params, batch_slots=3, max_len=MAX_LEN,
                       eos_token=cfg.vocab_size - 1, prefill_chunk=CHUNK,
                       observability=observability, device="cpu", **kw)
    for r in _trace(cfg):
        engine.submit(Request(**r))
    done = engine.run_until_drained()
    return engine, {r.uid: list(r.tokens_out) for r in done}


@pytest.mark.parametrize("kw", [{}, {"paged": False}, {"scheduler": "sync"}],
                         ids=["paged", "unpaged", "sync"])
def test_rho_eff_recorded_end_to_end(models, kw):
    _, base = _serve(models, **kw)
    obs = Observability()
    engine, out = _serve(models, observability=obs, **kw)
    assert out == base                       # greedy and stochastic alike
    sp = obs.sparsity.snapshot()
    m = engine.metrics
    assert sp["decode"]["dispatches"] == m.decode_dispatches > 0
    assert sp["prefill"]["dispatches"] == m.prefill_dispatches > 0
    for phase in ("decode", "prefill"):
        assert 0.0 < sp[phase]["rho_eff"] <= 1.0
        assert sp[phase]["rho_eff_per_layer"][:2] == [None, None]  # dense
        assert sp[phase]["blocks"]["selected"] > 0
    snap = obs.snapshot()
    assert snap["schema"] == "energon-obs-v1"
    assert snap["metrics"]["serve_rho_eff_decode"]["count"] > 0
    assert snap["metrics"]["serve_ticks"]["value"] == m.ticks
    assert len(obs.series["live_slots"]) == m.ticks
    json.dumps(snap)


def test_engine_without_observability_dispatches_the_plain_steps(
        models, monkeypatch):
    """No observability, injector or retry policy: every dispatch is the
    model's own method with no telemetry argument, nothing is traced,
    and the streams are those of an observed engine."""
    model = models[3]
    calls = []

    def recording(method):
        fn = getattr(model, method)

        def wrapper(*args, **kw):
            calls.append((method, tuple(sorted(kw))))
            return fn(*args, **kw)
        return wrapper

    for method in ("prefill", "decode_step"):
        monkeypatch.setattr(model, method, recording(method))
    engine, out = _serve(models)
    assert engine.obs is None and engine.allocator.tracer is None
    assert engine.metrics.registry is None
    assert {kw for _, kw in calls} == {()}
    assert sum(m == "prefill" for m, _ in calls) == \
        engine.metrics.prefill_dispatches
    assert sum(m == "decode_step" for m, _ in calls) == \
        engine.metrics.decode_dispatches
    calls.clear()
    _, observed = _serve(models, observability=Observability())
    assert {kw for _, kw in calls} == {("telemetry",)}
    assert observed == out


def test_device_telemetry_off_keeps_events_and_plain_steps(models):
    obs = Observability(device_telemetry=False)
    engine, out = _serve(models, observability=obs)
    assert not engine._telemetry
    assert engine._step_fn("decode_step") == engine.model.decode_step
    assert obs.sparsity.decode_dispatches == 0
    assert len(out) == 5 and len(obs.trace) > 0
    names = {e.name for e in obs.trace.events}
    assert {"admit", "prefill_tick", "decode_tick", "finish",
            "pool_occupancy"} <= names


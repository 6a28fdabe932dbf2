"""The port's ``ServeLoop`` on the paged pool with prefix sharing.

Against the reference: greedy streams equal to the JAX ``ServeLoop``'s
on one shared-prefix trace (same weights, carried by ``convert``).
In-port contracts, with stochastic requests in the mix: hybrid ≡ sync,
shared ≡ unshared, and preempted (tight pool) ≡ ample pool — each
request's stream must not depend on the schedule. Last, the
full-width serving config's shape rules, at a narrow width: the launcher's
defaults run every layer through the fused kernels, and ``ServeLoop``
refuses shapes that would leave them."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.models import LMModel as JaxLMModel
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch.configs import registry
from repro_torch.configs.registry import get_serve_config
from repro_torch.convert import convert_params
from repro_torch.kernels import ops as kops
from repro_torch.models import LMModel
from repro_torch.runtime import Request, ServeLoop
from tests._torch_port import jax_model_config

MAX_LEN, CHUNK = 64, 8


@pytest.fixture(scope="module")
def models():
    cfg = get_serve_config("qwen3-14b", smoke=True)
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return cfg, jmodel, jparams, model, params


def _trace(cfg, n_req=5, seed=7, stochastic=False, max_new=5):
    rng = np.random.default_rng(seed)
    prefix = [int(x) for x in rng.integers(1, cfg.vocab_size - 1, size=16)]
    out = []
    for uid in range(n_req):
        suffix = rng.integers(1, cfg.vocab_size - 1,
                              size=int(rng.integers(3, 20)))
        out.append(dict(
            uid=uid, prompt=prefix + [int(x) for x in suffix],
            max_new_tokens=max_new,
            temperature=0.9 if (stochastic and uid % 2) else 0.0,
        ))
    return out


def _serve(engine, trace, request_cls):
    for r in trace:
        engine.submit(request_cls(**r))
    done = engine.run_until_drained()
    return {r.uid: list(r.tokens_out) for r in done}


def _port(models, trace, **kw):
    cfg, _, _, model, params = models
    engine = ServeLoop(model, params, batch_slots=3, max_len=MAX_LEN,
                       eos_token=cfg.vocab_size - 1, prefill_chunk=CHUNK,
                       device="cpu", **kw)
    return _serve(engine, trace, Request), engine


def test_greedy_streams_match_reference(models):
    cfg, jmodel, jparams, _, _ = models
    trace = _trace(cfg)
    ref_engine = JaxServeLoop(
        jmodel, jparams, batch_slots=3, max_len=MAX_LEN,
        eos_token=cfg.vocab_size - 1, prefill_chunk=CHUNK,
    )
    ref = _serve(ref_engine, trace, JaxRequest)
    out, engine = _port(models, trace)
    assert out == ref
    assert engine.metrics.prefix_hits == ref_engine.metrics.prefix_hits > 0
    assert engine.metrics.prefill_tokens == ref_engine.metrics.prefill_tokens


def test_hybrid_equals_sync(models):
    trace = _trace(models[0], stochastic=True)
    hybrid, _ = _port(models, trace, scheduler="hybrid")
    sync, _ = _port(models, trace, scheduler="sync")
    assert hybrid == sync


def test_shared_equals_unshared(models):
    trace = _trace(models[0], seed=8, stochastic=True)
    shared, eng = _port(models, trace)
    unshared, _ = _port(models, trace, prefix_sharing=False)
    assert shared == unshared
    assert eng.metrics.prefill_tokens_skipped > 0


def test_preempted_equals_ample_pool(models):
    trace = _trace(models[0], n_req=6, seed=9, stochastic=True, max_new=12)
    ample, _ = _port(models, trace)
    tight, eng = _port(models, trace, num_pages=5)
    assert eng.metrics.preemptions > 0
    assert tight == ample
    eng.allocator.check_invariants()


def test_prompt_longer_than_the_cache_is_rejected(models):
    cfg, _, _, model, params = models
    engine = ServeLoop(model, params, batch_slots=2, max_len=MAX_LEN,
                       prefill_chunk=CHUNK, device="cpu")
    with pytest.raises(ValueError):
        engine.submit(Request(uid=0, prompt=[1] * (MAX_LEN + 1)))


def _narrow_full_config(arch="qwen3-14b", smoke=False):
    """qwen3-14b's serving config (G = 5, pages of 64, query block 128,
    planes from 1024 rows) at a width the CPU serves in seconds."""
    assert not smoke
    return dataclasses.replace(
        get_serve_config(arch), d_model=64, num_heads=10, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, dtype="float32",
    )


def test_serve_launcher_defaults_run_the_fused_kernels(monkeypatch):
    from repro_torch.launch import serve

    calls = {"prefill": 0, "decode": 0}

    def counted(kind, fn):
        def wrapper(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(registry, "get_serve_config", _narrow_full_config)
    monkeypatch.setattr(kops, "fused_paged_prefill_attention", counted(
        "prefill", kops.fused_paged_prefill_attention))
    monkeypatch.setattr(kops, "fused_paged_decode_attention", counted(
        "decode", kops.fused_paged_decode_attention))
    engine = serve.main([
        "--arch", "qwen3-14b", "--layers", "3", "--device", "cpu",
        "--requests", "2", "--batch-slots", "2", "--prompt-len", "150",
        "--new-tokens", "2",
    ])
    assert (engine.max_len, engine.prefill_chunk) == (4096, 128)
    assert [len(r.tokens_out) for r in engine.completed] == [2, 2]
    # one sparse layer (layers 0-1 are the dense prefix)
    assert calls["prefill"] == engine.metrics.prefill_dispatches > 0
    assert calls["decode"] == engine.metrics.decode_dispatches > 0


@pytest.mark.parametrize("max_len, chunk, fault", [
    (128, 128, "filter planes"),
    (4096, 64, "query_block 128 must divide the 320"),
    (4096, 256, "chunk_threshold"),
])
def test_serve_loop_refuses_shapes_off_the_path(max_len, chunk, fault):
    model = LMModel(_narrow_full_config(), device="cpu")
    with pytest.raises(ValueError, match=fault):
        ServeLoop(model, model.init(), max_len=max_len, prefill_chunk=chunk,
                  device="cpu")

"""The port's ``ServeLoop`` on the paged pool with prefix sharing.

Against the reference: greedy streams equal to the JAX ``ServeLoop``'s
on one shared-prefix trace (same weights, carried by ``convert``).
In-port contracts, with stochastic requests in the mix: hybrid ≡ sync,
shared ≡ unshared, and preempted (tight pool) ≡ ample pool — each
request's stream must not depend on the schedule. Last, the
full-width serving config's shape rules, at a narrow width: the launcher's
defaults run every layer through the fused kernels, shapes the fused
kernels do not take run the reference's fallbacks, and ``ServeLoop``
refuses what would fail mid-run."""

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


@pytest.mark.parametrize("impl, max_len, chunk, fault", [
    ("pallas", 4096, 256, "dense layers would mask 1280 folded rows"),
    ("mpmrf_block", 4096, 256, "prefill layers off the fused kernels"),
    ("bogus", 4096, 128, "impl='bogus' is not one of"),
])
def test_serve_loop_refuses_shapes_off_the_path(impl, max_len, chunk, fault):
    """What still fails mid-run is refused up front: a prefill chunk
    whose layers off the fused kernels (the dense prefix; every layer of
    the XLA impls) would mask past ``chunk_threshold``, and an unknown
    impl. Shapes the fused kernels do not take now take the reference's
    fallbacks (``test_serve_loop_serves_shapes_off_the_fused_kernels``)."""
    cfg = _narrow_full_config()
    cfg = dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, impl=impl))
    model = LMModel(cfg, device="cpu")
    with pytest.raises(ValueError, match=fault):
        ServeLoop(model, model.init(), max_len=max_len, prefill_chunk=chunk,
                  device="cpu")


def _count_fused(monkeypatch, names):
    calls = {name: 0 for name in names}
    for name in names:
        real = getattr(kops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(kops, name, counted)
    return calls


@pytest.mark.parametrize("max_len, chunk, fused", [
    # no resident planes below 1024 rows: the XLA block path, fresh
    # quantization, in prefill and decode
    (128, 128, ()),
    # 320 folded rows do not divide into query blocks of 128: prefill
    # falls back to the row path, decode stays fused
    (4096, 64, ("fused_paged_decode_attention",)),
])
def test_serve_loop_serves_shapes_off_the_fused_kernels(monkeypatch, max_len,
                                                        chunk, fused):
    calls = _count_fused(monkeypatch, ("fused_paged_prefill_attention",
                                       "fused_paged_decode_attention"))
    cfg = dataclasses.replace(_narrow_full_config(), num_layers=3)
    model = LMModel(cfg, device="cpu")
    engine = ServeLoop(model, model.init(), batch_slots=1, max_len=max_len,
                       prefill_chunk=chunk, eos_token=-1, device="cpu")
    engine.submit(Request(uid=0, prompt=list(range(1, 71)),
                          max_new_tokens=2))
    done = engine.run_until_drained()
    assert [len(r.tokens_out) for r in done] == [2]
    assert {k for k, v in calls.items() if v} == set(fused)


@pytest.mark.parametrize("model_overrides, energon_overrides, fault", [
    # 34 query heads over 2 KV heads: G = 17, past the decode kernels' 16
    ({"num_heads": 34}, {},
     "the decode kernels take at most 16 query heads per KV head (G=17)"),
    ({}, {"key_block": 4, "decode_key_block": 4},
     "decode_key_block 4 must be a multiple of 8, <= 128"),
    ({}, {"key_block": 256, "decode_key_block": 256},
     "decode_key_block 256 must be a multiple of 8, <= 128"),
])
def test_serve_loop_refuses_shapes_off_the_decode_filter(
        model_overrides, energon_overrides, fault):
    """Rows and key blocks that the decode filter (B1 / B5) does not take
    are refused up front, before a decode step would raise mid-run."""
    cfg = _narrow_full_config()
    cfg = dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, **energon_overrides), **model_overrides)
    model = LMModel(cfg, device="cpu")
    with pytest.raises(ValueError, match=fault.replace("(", r"\(")
                       .replace(")", r"\)")):
        ServeLoop(model, model.init(), max_len=4096, prefill_chunk=128,
                  device="cpu")

"""The recurrent families — xlstm-1.3b (ssm: groups of mLSTM + sLSTM) and
zamba2-7b (hybrid: Mamba2 + one shared attention block) — in the port
against the reference, on the CPU.

The configs equal the reference's; the init trees have its leaves,
shapes and dtypes (the Mamba2 leaves ``a_log`` / ``dt_bias`` /
``d_skip`` f32 in a bf16 model). With the reference's weights carried
across by ``repro_torch.convert``: ``apply`` logits and ``loss``,
``decode_step`` logits and every cache leaf over steps under an
``active`` mask, and ``reset_decode_slots`` (the reset slots are the
mask's True ones). The smoke configs' shared block runs ``mpmrf_row``,
held at ρ = 1, where a q/k code on a rounding boundary cannot flip a
selected row (ROADMAP §C); the fused path's ``pallas`` runs at the
serve-smoke config, planes resident at smoke lengths.

The engine: ``ServeLoop`` greedy streams and dispatch counts equal the
reference engine's (EOS −1) under both schedulers, for the reference's
own serving-engine cases — the sequential fallback, a wave's
max(Lᵢ) − 1 dispatches, a neighbour unchanged by an admission, the
reset polarity — and for a live decode neighbour during a wave (the
reference writes a K/V row at the neighbour's length, which its next
token overwrites; the port steps it at the sentinel). The decode step
makes no host sync, and an idle step leaves every state and K/V leaf as
it was. Paged, mesh and replicated-mesh serving are refused with the
reference's reasons.

Tolerances: logits at atol = rtol = 1e-4 (as ``test_torch_model.py``:
the same fp32 graph in other summation orders); the loss at rtol 1e-5;
the f32 states at atol 1e-5, rtol 1e-4; streams and counts exactly."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LMModel as JaxLMModel
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch.configs import registry
from repro_torch.convert import convert_params
from repro_torch.models import LMModel
from repro_torch.runtime import Request, ServeLoop
from tests._torch_port import jax_model_config, n, t
from tests.test_torch_graph import HostSyncGuard

ARCHS = {"xlstm-1.3b": "xlstm_1_3b", "zamba2-7b": "zamba2_7b"}
TOL = dict(atol=1e-4, rtol=1e-4)
STATE_TOL = dict(atol=1e-5, rtol=1e-4)
EOS = -1
MAX_LEN = 48


def _rho1(cfg):
    return dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, pruning_ratio=1.0))


#: smoke configs at ρ = 1, and zamba2's serve-smoke config (pallas)
CONFIGS = {
    "xlstm": lambda: registry.get_smoke_config("xlstm-1.3b"),
    "zamba2": lambda: _rho1(registry.get_smoke_config("zamba2-7b")),
    "zamba2-pallas": lambda: registry.get_serve_config("zamba2-7b",
                                                       smoke=True),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    port = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    ref = importlib.import_module(f"repro.configs.{ARCHS[arch]}")
    assert arch in registry.ARCH_NAMES
    assert jax_model_config(port.CONFIG) == ref.CONFIG
    assert jax_model_config(port.smoke()) == ref.smoke()
    assert registry.get_config(arch) is port.CONFIG
    impl = registry.get_serve_config(arch).energon.impl
    assert impl == ("pallas" if arch == "zamba2-7b" else "dense")
    model = LMModel(port.CONFIG, device="meta")
    assert not model.supports_prefill and not model.supports_paged


def _tree(tree, leaf):
    if isinstance(tree, dict):
        return {k: _tree(v, leaf) for k, v in tree.items()}
    return leaf(tree)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_the_reference(arch, full):
    """Leaves, shapes and dtypes (the full config on the meta device:
    the bf16 model with its f32 Mamba2 leaves)."""
    cfg = (registry.get_config if full else registry.get_smoke_config)(arch)
    ref = jax.eval_shape(JaxLMModel(jax_model_config(cfg)).init,
                         jax.random.PRNGKey(0))
    model = LMModel(cfg, device="meta" if full else "cpu")
    shape = _tree(ref, lambda a: tuple(a.shape))
    assert model.param_shapes() == shape
    assert _tree(model.param_dtypes(), lambda d: str(d).split(".")[-1]) \
        == _tree(ref, lambda a: str(a.dtype))
    if not full:
        assert _tree(model.init(seed=0), lambda a: tuple(a.shape)) == shape
    if arch == "zamba2-7b":
        assert "blocks" not in shape and "mlp" in shape["shared"]
        cell = model.param_dtypes()["mamba_pre"]["cell"]
        assert cell["a_log"] == cell["d_skip"] == torch.float32


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]()
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return request.param, jmodel, jparams, model, params


def test_apply_and_loss_match_the_reference(pair):
    _, jmodel, jparams, model, params = pair
    rng = np.random.default_rng(9)
    toks, tgts = (rng.integers(1, 255, size=(2, 32)).astype(np.int32)
                  for _ in range(2))
    jbatch = {"inputs": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    batch = {"inputs": t(toks), "targets": t(tgts)}
    ref_logits, _ = jax.jit(jmodel.apply)(jparams, jbatch)
    logits, aux = model.apply(params, batch)
    np.testing.assert_allclose(n(logits), n(ref_logits), **TOL)
    assert float(aux) == 0.0
    ref_loss, _ = jax.jit(jmodel.loss)(jparams, jbatch)
    loss, metrics = model.loss(params, batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert float(metrics["tokens"]) == 64


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def test_decode_steps_and_states_match_the_reference(pair):
    """Six steps of three slots under an ``active`` mask that parks a
    different slot each step (its state must not move), then every
    cache leaf — the recurrent states and the hybrid's shared K/V
    cache and planes."""
    name, jmodel, jparams, model, params = pair
    step = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_cache(3, MAX_LEN)
    cache = model.init_cache(3, MAX_LEN)
    assert dict((k, tuple(v.shape)) for k, v in _leaves(cache)) == dict(
        (k, tuple(v.shape)) for k, v in _leaves(jcache))
    rng = np.random.default_rng(1)
    idx = np.zeros(3, np.int32)
    for s in range(6):
        active = np.arange(3) != s % 3
        toks = rng.integers(1, 255, size=(3, 1)).astype(np.int32)
        inputs = {"tokens": toks, "active": active}
        ref, jcache = step(jparams, jcache, {k: jnp.asarray(v) for k, v in
                                             inputs.items()}, jnp.asarray(idx))
        # the reference writes every slot's K/V row; the engine gives a
        # parked slot the sentinel, so here every slot writes (positional)
        out, cache = model.decode_step(
            params, cache, {k: t(v) for k, v in inputs.items()}, t(idx))
        np.testing.assert_allclose(n(out), n(ref), **TOL)
        idx = idx + active
    ref_leaves = dict(_leaves(jcache))
    for key, leaf in _leaves(cache):
        ref = np.asarray(ref_leaves[key], np.float32)
        if key.endswith("k_codes"):
            assert np.abs(n(leaf).astype(np.float32) - ref).max() <= 1, key
        else:
            np.testing.assert_allclose(n(leaf.float()), ref, **STATE_TOL,
                                       err_msg=key)


def test_telemetry_reports_no_layers(pair):
    _, _, _, model, params = pair
    cache = model.init_cache(2, MAX_LEN)
    inputs = {"tokens": torch.tensor([[3], [4]], dtype=torch.int32)}
    logits, _, stats = model.decode_step(params, cache, inputs,
                                         torch.zeros(2, dtype=torch.int32),
                                         telemetry=True)
    assert stats.shape == (0, 2, 4) and stats.dtype == torch.int32
    assert logits.shape == (2, 1, 256)


def _ones_like_cache(cache):
    for _, leaf in _leaves(cache):
        leaf.fill_(1)


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_decode_slots_matches_the_reference(arch):
    """The reset slots are the True ones (the reference's docstring
    records the old reversed polarity): state leaves on batch axis 2
    (``mlstm``, ``mamba_pre``) or 1, and the hybrid's shared K/V rows,
    codes and scales where impl ≠ dense."""
    for cfg in (registry.get_smoke_config(arch),
                registry.get_serve_config(arch, smoke=True)):
        jmodel = JaxLMModel(jax_model_config(cfg))
        model = LMModel(cfg, device="cpu")
        mask = np.array([False, True, False])
        ref = jmodel.reset_decode_slots(
            jax.tree.map(jnp.ones_like, jmodel.init_cache(3, MAX_LEN)),
            jnp.asarray(mask))
        cache = model.init_cache(3, MAX_LEN)
        _ones_like_cache(cache)
        out = model.reset_decode_slots(cache, t(mask))
        ref_leaves = dict(_leaves(ref))
        for key, leaf in _leaves(out):
            np.testing.assert_array_equal(
                n(leaf.float()), np.asarray(ref_leaves[key], np.float32),
                err_msg=key)
        assert any(float(np.asarray(v).min()) == 0
                   for k, v in ref_leaves.items())


def test_decode_step_makes_no_host_sync(pair):
    _, _, _, model, params = pair
    cache = model.init_cache(3, MAX_LEN)
    inputs = {"tokens": torch.tensor([[3], [4], [5]], dtype=torch.int32),
              "active": torch.tensor([True, False, True])}
    index = torch.tensor([0, MAX_LEN * 2, 0], dtype=torch.int32)
    with HostSyncGuard() as guard:
        logits, _ = model.decode_step(params, cache, inputs, index)
    assert guard.seen == []
    assert torch.isfinite(logits).all()


def test_an_idle_step_leaves_the_cache_as_it_was(pair):
    """The graphed step's warm-up and capture inputs (every slot
    inactive): no state, K/V row, code or scale changes — reset slots'
    all-zero blocks included."""
    from repro_torch.runtime.cuda_graph import idle_inputs, run_idle

    _, _, _, model, params = pair
    cache = model.init_cache(3, MAX_LEN)
    rng = np.random.default_rng(2)
    for s in range(4):
        inputs = {"tokens": t(rng.integers(1, 255, size=(3, 1)).astype(
            np.int32))}
        model.decode_step(params, cache, inputs,
                          torch.full((3,), s, dtype=torch.int32))
    model.reset_decode_slots(cache, torch.tensor([False, False, True]))
    inputs = {"tokens": torch.zeros((3, 1), dtype=torch.int32),
              "active": torch.ones(3, dtype=torch.bool)}
    static, index = idle_inputs(model, "decode_step", cache, inputs,
                                torch.zeros(3, dtype=torch.int32))
    assert not static["active"].any()
    before = {k: v.clone() for k, v in _leaves(cache)}
    run_idle(model, "decode_step", params, cache, static, index)
    for key, leaf in _leaves(cache):
        assert torch.equal(leaf, before[key]), key


# --------------------------------------------------------------------------
# the engine against the reference's
# --------------------------------------------------------------------------

def _engines(pair, **kw):
    _, jmodel, jparams, model, params = pair
    kw = dict(dict(batch_slots=2, max_len=MAX_LEN, eos_token=EOS,
                   prefill_chunk=8), **kw)
    return (JaxServeLoop(jmodel, jparams, **kw),
            ServeLoop(model, params, device="cpu", **kw))


def _streams(engine):
    return {r.uid: list(r.tokens_out) for r in engine.completed}


@pytest.mark.parametrize("scheduler", ["hybrid", "sync"])
def test_greedy_streams_and_dispatches_match_the_reference(pair,
                                                           scheduler):
    """Three requests through two slots: the sequential fallback (no
    prefill step), waves of max(Lᵢ) − 1 dispatches and a slot reused by
    a later admission (its state reset)."""
    name, *_ = pair
    rng = np.random.default_rng(11)
    lens = (9, 5, 12)
    out = []
    for engine, req in zip(_engines(pair, scheduler=scheduler),
                           (JaxRequest, Request)):
        for u, k in enumerate(lens):
            engine.submit(req(uid=u, prompt=[int(x) for x in rng.integers(
                1, 255, size=k)], max_new_tokens=4))
        engine.run_until_drained()
        m = engine.metrics
        out.append((_streams(engine), m.prefill_dispatches,
                    m.prefill_tokens, m.decode_dispatches))
        rng = np.random.default_rng(11)
    assert not out[1][0] == {} and all(len(s) == 4 for s in out[1][0].values())
    assert out[1] == out[0]
    # waves: uids 0 and 1 together (8 steps), then uid 2 alone (11)
    assert out[1][1] == 8 + 11 and out[1][2] == sum(k - 1 for k in lens)


def test_a_wave_costs_the_longest_prompt(pair):
    """The reference's case: prompts of 7 and 3 tokens admitted in one
    tick cost 6 decode dispatches and 6 + 2 prefill tokens."""
    engine = _engines(pair)[1]
    engine.submit(Request(uid=0, prompt=[1, 2, 3, 4, 5, 6, 7],
                          max_new_tokens=2))
    engine.submit(Request(uid=1, prompt=[8, 9, 10], max_new_tokens=2))
    engine.tick()
    assert engine.metrics.prefill_dispatches == 6
    assert engine.metrics.prefill_tokens == 6 + 2
    assert engine.metrics.decode_dispatches == 1
    assert all(r.state == "decode" for r in engine.slots)


def _with_neighbour(engine, req, neighbour: bool):
    engine.submit(req(uid=0, prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=8))
    engine.tick()
    engine.tick()                    # uid 0 is mid-decode …
    if neighbour:                    # … when a neighbour's wave arrives
        engine.submit(req(uid=1, prompt=[7, 8, 9, 10, 11, 12, 13, 14, 15,
                                         16, 17, 18, 19, 20, 21, 22, 23],
                          max_new_tokens=8))
    engine.run_until_drained()
    return _streams(engine)


def test_a_live_neighbour_is_unchanged_by_a_wave(pair):
    """The reference's isolation case, and the same schedule through the
    reference engine: uid 0 decodes on while uid 1's 16-step wave runs
    beside it, its recurrent state parked and (hybrid) no K/V row of it
    written; both streams equal the reference's."""
    ref, port = _engines(pair)
    alone = _with_neighbour(_engines(pair)[1], Request, False)
    ref_streams = _with_neighbour(ref, JaxRequest, True)
    streams = _with_neighbour(port, Request, True)
    assert streams == ref_streams
    assert streams[0] == alone[0]
    assert port.metrics.prefill_dispatches == 5 + 16


def test_reset_polarity_on_a_reused_slot(pair):
    """One slot served twice: the second request's stream does not
    depend on the first's (its admission zeroed the slot), and equals
    its stream on a fresh engine."""
    _, _, _, model, params = pair
    kw = dict(batch_slots=1, max_len=MAX_LEN, eos_token=EOS, device="cpu")
    engine = ServeLoop(model, params, **kw)
    for u, prompt in enumerate(([5, 6, 7, 8, 9], [10, 11, 12])):
        engine.submit(Request(uid=u, prompt=prompt, max_new_tokens=5))
    engine.run_until_drained()
    fresh = ServeLoop(model, params, **kw)
    fresh.submit(Request(uid=1, prompt=[10, 11, 12], max_new_tokens=5))
    fresh.run_until_drained()
    assert _streams(engine)[1] == _streams(fresh)[1]


def test_refusals(pair):
    """Paged serving, a mesh (the reference's needs the paged cache) and
    replicas on a mesh are refused at construction; chunked prefill and
    the page pool by the model."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import ReplicatedServeLoop

    _, _, _, model, params = pair
    kw = dict(batch_slots=2, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="attention family"):
        ServeLoop(model, params, paged=True, **kw)
    with pytest.raises(ValueError, match="requires the paged cache"):
        ServeLoop(model, params, mesh=make_mesh((1, 2), devices=["cpu"] * 2),
                  **kw)
    with pytest.raises(ValueError, match="requires the paged cache"):
        ReplicatedServeLoop(model, params,
                            mesh=make_mesh((2, 1), devices=["cpu"] * 2),
                            **kw)
    with pytest.raises(NotImplementedError, match=model.cfg.family):
        model.prefill(params, model.init_cache(1, MAX_LEN),
                      {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                      torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="family"):
        model.init_paged_cache(8)
    engine = ServeLoop(model, params, **kw)
    assert not engine.paged and engine.graphs == []


def test_the_launcher_serves_sequentially_and_refuses_a_mesh(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu",
                "--requests", "3", "--prompt-len", "6", "--new-tokens",
                "3"])
    out = capsys.readouterr().out
    assert "[serve] prefill (sequential): 15 tok in 5 dispatches" in out
    with pytest.raises(ValueError, match="requires the paged cache"):
        serve.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
                    "--mesh", "1x2", "--simulate-devices", "2"])

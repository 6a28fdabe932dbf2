"""The MoE family — ``models/moe.py``, the MoE block in the model and the
serving engine, olmoe-1b-7b and qwen3-moe-235b-a22b — in the port
against the reference, on the CPU.

* ``apply_moe`` against ``_apply_moe_reference`` at the smoke sizes, at
  capacity factors that drop (0.25) and that do not (8.0): the integer
  stages (top-k experts, positions, keep, capacity) exactly, on inputs
  whose top-k probabilities are checked clear of ties, and on all-tied
  probabilities (lower expert first, as ``jax.lax.top_k``); outputs at
  atol = rtol = 1e-5 in fp32, the aux loss and drop fraction too; an
  expert whose output is NaN spreads to the same rows (a dropped
  assignment's gather of ``(e, 0)`` included); equal rows in several
  slots of one call kept slot-major.
* Both smoke configs: the configs and init trees against the
  reference's; a bf16 tree keeps the router in f32 through ``init`` and
  ``convert_params``; ``apply`` logits and ``loss`` (aux included) with
  impl ``pallas`` (the serve-smoke config) and ``mpmrf_row`` (the smoke
  config at ρ = 1, below); paged ``prefill`` / ``decode_step`` logits
  and cache on the serve-smoke config.
* Greedy ``ServeLoop`` streams equal the JAX engine's under the same
  settings — hybrid, sync, unpaged, a pool tight enough to preempt — on
  a trace where the reference itself breaks two of its contracts for
  MoE, which is recorded: its hybrid streams differ from its sync ones,
  its preempting pool's from its ample pool's (the slots of a step are
  coupled through expert capacity, sentinel rows included). The port is
  held to what the reference does, not to those contracts.
* The MoE serve steps under the graph dispatch guard; an MoE model on a
  mesh whose model axis is > 1 served by ``ServeLoop`` and the launcher
  on the expert-parallel path (its parity with the reference's mesh
  engines is ``test_torch_moe_ep.py``'s), a data axis > 1 inside one
  MoE call refused; replicas on a ``(2, 1)`` mesh giving the reference's
  replicated streams.

Tolerances: the layer at atol = rtol = 1e-5, logits at 1e-4 and the
loss at rtol 1e-5, as ``test_torch_dense_configs.py`` (both sides
compute the same fp32 graph in different summation orders); integer
stages and streams exactly."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LMModel as JaxLMModel
from repro.models import moe as jmoe
from repro.runtime import ReplicatedServeLoop as JaxReplicated
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch.configs import registry
from repro_torch.convert import convert_params
from repro_torch.distributed import sharding as shd
from repro_torch.models import LMModel
from repro_torch.models import moe
from repro_torch.runtime import ReplicatedServeLoop, Request, ServeLoop
from tests._torch_port import jax_model_config, n, t
from tests.test_torch_graph import HostSyncGuard, _filled
from tests.test_torch_mesh import cpu_mesh

ARCHS = {"olmoe-1b-7b": "olmoe_1b_7b",
         "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b"}
TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
#: the least gap between a token's consecutive top-(k+1) probabilities
#: (fp64) that the tie-free inputs keep: far above either framework's
#: fp32 rounding of them
GAP = 1e-5
SEQ, MAX_LEN, CHUNK, EOS = 64, 64, 16, -1


def _serve_smoke(arch):
    """The arch's serve-smoke config (impl pallas, blocks of 16, layers
    0–1 dense); olmoe's at 3 layers, so that one MoE layer (2) sits
    above the fused kernels' plain versions, as qwen3-moe's does."""
    cfg = registry.get_serve_config(arch, smoke=True)
    if cfg.num_layers <= cfg.energon.min_prune_layer:
        cfg = dataclasses.replace(
            cfg, num_layers=cfg.energon.min_prune_layer + 1)
    return cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    port = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    ref = importlib.import_module(f"repro.configs.{ARCHS[arch]}")
    assert arch in registry.ARCH_NAMES
    assert jax_model_config(port.CONFIG) == ref.CONFIG
    assert jax_model_config(port.smoke()) == ref.smoke()
    assert registry.get_config(arch) is port.CONFIG
    assert registry.get_serve_config(arch).energon.impl == "pallas"
    LMModel(port.CONFIG, device="meta")        # every full config builds
    LMModel(port.smoke(), device="cpu")


def test_other_families_are_still_refused():
    """Every family of the reference builds (dense, moe, vlm, audio, ssm
    and hybrid); a family the reference does not know is refused, as the
    reference refuses it."""
    cfg = registry.get_smoke_config("olmoe-1b-7b")
    for family in ("rnn", "encoder"):
        with pytest.raises(ValueError, match=f"unknown family {family}"):
            LMModel(dataclasses.replace(cfg, family=family), device="cpu")
    for arch in ("llava-next-34b", "musicgen-medium", "zamba2-7b",
                 "xlstm-1.3b"):
        LMModel(registry.get_smoke_config(arch), device="cpu")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _dtypes(tree):
    if isinstance(tree, dict):
        return {k: _dtypes(v) for k, v in tree.items()}
    return str(tree.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_the_reference(arch):
    cfg = registry.get_smoke_config(arch)
    ref = jax.eval_shape(JaxLMModel(jax_model_config(cfg)).init,
                         jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = model.init(seed=0)
    assert _shapes(params) == _shapes(ref) == model.param_shapes()
    assert "mlp" not in params["blocks"]
    assert set(params["blocks"]["moe"]) == {"router", "w_up", "w_gate",
                                            "w_down"}


def test_a_bf16_router_stays_f32():
    """``convert_params`` of a bf16 olmoe smoke tree keeps the router f32
    and every other leaf bf16, as the reference's init and the port's
    give them (the old cast took every float leaf to the model dtype)."""
    cfg = dataclasses.replace(registry.get_smoke_config("olmoe-1b-7b"),
                              dtype="bfloat16")
    jparams = JaxLMModel(jax_model_config(cfg)).init(jax.random.PRNGKey(0))
    want = jax.tree.map(lambda a: f"torch.{a.dtype}", jparams)
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    assert want["blocks"]["moe"]["router"] == "torch.float32"
    assert want["blocks"]["moe"]["w_up"] == "torch.bfloat16"
    assert _dtypes(params) == want == _dtypes(model.init(seed=0))
    assert model.param_dtypes()["blocks"]["moe"]["router"] == torch.float32
    # the router's values are the reference's f32 bits, not bf16-rounded
    np.testing.assert_array_equal(
        n(params["blocks"]["moe"]["router"]),
        np.asarray(jparams["blocks"]["moe"]["router"]))


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------


def _moe_cfgs(arch, factor):
    cfg = registry.get_smoke_config(arch)
    port = moe.MoEConfig(
        num_experts=cfg.num_experts, experts_per_token=cfg.experts_per_token,
        d_model=cfg.d_model, d_ff=cfg.d_ff, activation=cfg.activation,
        capacity_factor=factor)
    return port, jmoe.MoEConfig(**dataclasses.asdict(port))


def _clear_of_ties(rng, router, shape, k):
    """Normal rows redrawn until each row's top-(k+1) probabilities (in
    fp64) are ≥ GAP apart, so either framework's top k, in order, is the
    same."""
    x = rng.standard_normal(shape).astype(np.float32).reshape(-1, shape[-1])
    for _ in range(50):
        logits = x.astype(np.float64) @ router.astype(np.float64)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p = -np.sort(-(p / p.sum(-1, keepdims=True)), axis=-1)[:, :k + 1]
        bad = (np.diff(-p, axis=-1) < GAP).any(-1)
        if not bad.any():
            return x.reshape(shape)
        x[bad] = rng.standard_normal((int(bad.sum()), shape[-1]))
    raise AssertionError("no tie-free rows drawn")


def _reference_routing(jparams, xt, jcfg):
    """The integer stages of ``_apply_moe_reference`` (moe.py:141-159),
    which the function does not return: the same JAX ops."""
    e, k = jcfg.num_experts, jcfg.experts_per_token
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32),
                        jparams["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    flat_pos = jnp.sum(pos * onehot, axis=-1)
    cap = max(1, int(xt.shape[0] * k / e * jcfg.capacity_factor))
    return np.asarray(top_e), np.asarray(flat_pos), np.asarray(
        flat_pos < cap), cap


def _layer_case(arch, factor, seed=0, tied=False):
    cfg, jcfg = _moe_cfgs(arch, factor)
    jparams = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    np_params = {k: np.array(v) for k, v in jparams.items()}
    if tied:      # every probability 1/E: the top k are experts 0..k-1
        np_params["router"][:] = 0.0
    rng = np.random.default_rng(seed)
    shape = (2, 24, cfg.d_model)
    x = (rng.standard_normal(shape).astype(np.float32) if tied else
         _clear_of_ties(rng, np_params["router"], shape,
                        cfg.experts_per_token))
    return cfg, jcfg, np_params, x


def _check_layer(cfg, jcfg, np_params, x):
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    params = {k: t(v) for k, v in np_params.items()}
    xt = x.reshape(-1, x.shape[-1])
    top_e, flat_pos, keep, cap = _reference_routing(jparams, jnp.asarray(xt),
                                                    jcfg)
    _, _, p_top_e, p_pos, p_keep, p_cap = moe.route(params, t(xt), cfg)
    assert p_cap == cap == moe.capacity(xt.shape[0], cfg)
    np.testing.assert_array_equal(n(p_top_e), top_e)
    np.testing.assert_array_equal(n(p_pos), flat_pos)
    np.testing.assert_array_equal(n(p_keep), keep)
    ref, ref_m = jmoe._apply_moe_reference(jparams, jnp.asarray(x), jcfg)
    out, met = moe.apply_moe(params, t(x), cfg)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(n(out), n(ref), **LAYER_TOL)
    np.testing.assert_allclose(float(met["moe_aux_loss"]),
                               float(ref_m["moe_aux_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["moe_drop_fraction"]),
                               float(ref_m["moe_drop_fraction"]), rtol=1e-6)
    return keep, out


@pytest.mark.parametrize("factor", [0.25, 8.0], ids=["drops", "keeps"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_the_reference(arch, factor):
    keep, _ = _check_layer(*_layer_case(arch, factor))
    assert keep.all() == (factor == 8.0)


@pytest.mark.parametrize("factor", [0.25, 8.0], ids=["drops", "keeps"])
def test_tied_probabilities_route_as_the_reference(factor):
    cfg, jcfg, np_params, x = _layer_case("olmoe-1b-7b", factor, tied=True)
    keep, _ = _check_layer(cfg, jcfg, np_params, x)
    _, _, top_e, _, _, _ = moe.route({"router": t(np_params["router"])},
                                     t(x.reshape(-1, x.shape[-1])), cfg)
    assert (n(top_e) == np.arange(cfg.experts_per_token)).all()
    assert keep.all() == (factor == 8.0)


def test_equal_rows_of_one_call_are_kept_slot_major():
    """Four slots holding the same rows (a shared prefix prefilled in one
    wave) route alike, but capacity ranks the assignments slot-major, so
    the later slots keep fewer — in the reference as in the port. Their
    outputs differ, and so do the K/V rows a later layer writes for
    them: a request that attaches another slot's copy of the prefix
    reads rows it did not write (``chip_smoke.py``'s
    ``[olmoe-serve]`` run 2)."""
    cfg, jcfg, np_params, x = _layer_case("olmoe-1b-7b", 1.25)
    x = np.broadcast_to(x[:1], (4,) + x.shape[1:]).copy()
    keep, out = _check_layer(cfg, jcfg, np_params, x)
    kept = keep.reshape(4, -1).sum(-1)
    assert list(kept) == sorted(kept, reverse=True) and kept[0] > kept[-1]
    assert not np.array_equal(n(out)[0], n(out)[-1])


def test_a_nan_expert_spreads_as_in_the_reference():
    """Expert 3's output NaN: every token with a kept assignment to it,
    and every token with a dropped assignment that gathers row (3, 0)
    at weight 0, comes out NaN in both (a mask in place of the weight
    would hide the second kind)."""
    cfg, jcfg, np_params, x = _layer_case("olmoe-1b-7b", 0.25)
    np_params["w_down"][3, 0, :] = np.nan
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    ref, _ = jmoe._apply_moe_reference(jparams, jnp.asarray(x), jcfg)
    out, _ = moe.apply_moe({k: t(v) for k, v in np_params.items()}, t(x),
                           cfg)
    top_e, _, keep, _ = _reference_routing(
        jparams, jnp.asarray(x.reshape(-1, x.shape[-1])), jcfg)
    to3 = (top_e.reshape(-1) == 3).reshape(top_e.shape)
    dropped_to3 = (to3 & ~keep.reshape(top_e.shape)).any(-1)
    nan_rows = np.isnan(n(out)).all(-1).reshape(-1)
    assert dropped_to3.any() and nan_rows[dropped_to3].all()
    np.testing.assert_array_equal(np.isnan(n(out)), np.isnan(n(ref)))
    np.testing.assert_allclose(n(out)[~np.isnan(n(out))],
                               n(ref)[~np.isnan(n(ref))], **LAYER_TOL)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


PAIRS = [(arch, impl) for arch in ARCHS for impl in ("mpmrf_row", "pallas")]


def _pair_id(p):
    return f"{p[0]}-{p[1]}"


@pytest.fixture(scope="module")
def pair(request):
    """The arch's serve-smoke config (impl pallas, pages of 16) or its
    smoke config (impl mpmrf_row) in both packages, the reference's
    weights carried across. The smoke config runs at ρ = 1: at its ρ = 4
    the row selection compares scores of int16 codes rounded from fp32
    q/k that the two frameworks compute to within an ulp, and a code on
    a rounding boundary flips a selected row (3 of the 128 rows of
    olmoe's smoke model, 33 of qwen3-14b's dense one) — a property of
    the mpmrf_row path at model level, not of the MoE block (ROADMAP §C;
    ``test_torch_xla_paths.py`` holds the row selection to the
    reference on inputs without boundary codes)."""
    arch, impl = request.param
    if impl == "mpmrf_row":
        cfg = registry.get_smoke_config(arch)
        cfg = dataclasses.replace(cfg, energon=dataclasses.replace(
            cfg.energon, pruning_ratio=1.0))
    else:
        cfg = _serve_smoke(arch)
    assert cfg.energon.impl == impl
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return cfg, jmodel, jparams, model, params


@pytest.mark.parametrize("pair", PAIRS, ids=_pair_id, indirect=True)
def test_apply_and_loss_match_the_reference(pair):
    cfg, jmodel, jparams, model, params = pair
    rng = np.random.default_rng(9)
    toks, tgts = (rng.integers(1, cfg.vocab_size - 1, size=(2, SEQ)).astype(
        np.int32) for _ in range(2))
    jbatch = {"inputs": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    batch = {"inputs": t(toks), "targets": t(tgts)}
    ref_logits, ref_aux = jax.jit(jmodel.apply)(jparams, jbatch)
    logits, aux = model.apply(params, batch)
    np.testing.assert_allclose(n(logits), n(ref_logits), **TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    assert float(aux) > 0
    ref_loss, ref_m = jax.jit(jmodel.loss)(jparams, jbatch)
    loss, metrics = model.loss(params, batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(ref_m["aux"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(ref_m["ce"]),
                               rtol=1e-5)
    assert float(metrics["tokens"]) == 2 * SEQ


@pytest.mark.parametrize("pair", [p for p in PAIRS if p[1] == "pallas"],
                         ids=_pair_id, indirect=True)
def test_paged_prefill_and_decode_match_the_reference(pair):
    cfg, jmodel, jparams, model, params = pair
    prefill, decode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    tables = np.array([[3, 0, 5, 1], [2, 7, 4, 6]], np.int32)
    jcache = jmodel.init_paged_cache(8, max_len=MAX_LEN)
    cache = model.init_paged_cache(8, max_len=MAX_LEN)
    rng = np.random.default_rng(0)
    lens = [24, 19]
    prompts = [rng.integers(1, cfg.vocab_size - 1, size=k) for k in lens]
    zero = np.zeros(2, np.int32)
    for c in range(2):
        toks = np.zeros((2, CHUNK), np.int32)
        pos = np.full((2, CHUNK), MAX_LEN, np.int32)    # sentinels
        for b, p in enumerate(prompts):
            part = p[c * CHUNK:(c + 1) * CHUNK]
            toks[b, :len(part)] = part
            pos[b, :len(part)] = c * CHUNK + np.arange(len(part))
        inputs = {"tokens": toks, "positions": pos, "block_table": tables}
        ref, jcache = prefill(
            jparams, jcache, {k: jnp.asarray(v) for k, v in inputs.items()},
            jnp.asarray(zero))
        out, cache = model.prefill(
            params, cache, {k: t(v) for k, v in inputs.items()}, t(zero))
        real = pos < MAX_LEN
        np.testing.assert_allclose(n(out)[real], n(ref)[real], **TOL)
    idx = np.array(lens, np.int32)
    nxt = np.array([[5], [9]], np.int32)
    for _ in range(3):
        inputs = {"tokens": nxt, "active": np.array([True, True]),
                  "block_table": tables}
        ref, jcache = decode(
            jparams, jcache, {k: jnp.asarray(v) for k, v in inputs.items()},
            jnp.asarray(idx))
        out, cache = model.decode_step(
            params, cache, {k: t(v) for k, v in inputs.items()}, t(idx))
        np.testing.assert_allclose(n(out), n(ref), **TOL)
        nxt = np.asarray(ref[:, -1].argmax(-1), np.int32)[:, None]
        idx = idx + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(n(cache[key]), n(jcache[key]),
                                   atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# the serving engine
# --------------------------------------------------------------------------

#: (prompt length, new tokens): short and multi-chunk prompts, so the
#: engines admit while others decode and a tight pool preempts
TRACE_SPEC = ((15, 40), (47, 8), (10, 20), (30, 12), (15, 30), (40, 6))
ENGINES = {
    "hybrid": dict(batch_slots=3, prefill_chunk=8),
    "sync": dict(batch_slots=3, prefill_chunk=8, scheduler="sync"),
    "unpaged": dict(batch_slots=3, prefill_chunk=8, paged=False),
    "ample": dict(batch_slots=2, prefill_chunk=16),
    "preempting": dict(batch_slots=2, prefill_chunk=16, num_pages=4),
}


@pytest.fixture(scope="module")
def olmoe():
    cfg = _serve_smoke("olmoe-1b-7b")
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return dict(jmodel=jmodel, jparams=jparams, model=model, params=params,
                trace=_trace(cfg, TRACE_SEED), runs={})


#: the engine trace's prompts: drawn from seed 3 (seed 1's draw parts the
#: preempting pools, recorded below)
TRACE_SEED = 3


def _trace(cfg, seed, spec=TRACE_SPEC):
    rng = np.random.default_rng(seed)
    return [dict(uid=u, prompt=[int(x) for x in rng.integers(
        1, cfg.vocab_size - 1, size=length)], max_new_tokens=new)
        for u, (length, new) in enumerate(spec)]


def _drain(engine, trace, request_cls):
    for r in trace:
        engine.submit(request_cls(**r))
    engine.run_until_drained()
    return {r.uid: list(r.tokens_out) for r in engine.completed}


def _engine(olmoe, name, port):
    kw = dict(ENGINES[name], max_len=MAX_LEN, eos_token=EOS)
    if port:
        return ServeLoop(olmoe["model"], olmoe["params"], device="cpu", **kw)
    return JaxServeLoop(olmoe["jmodel"], olmoe["jparams"], **kw)


def _run(olmoe, name, port):
    """The greedy streams (and preemptions) of ``ENGINES[name]`` through
    the port's engine or the reference's, each run once a module."""
    key = (name, port)
    if key not in olmoe["runs"]:
        engine = _engine(olmoe, name, port)
        streams = _drain(engine, olmoe["trace"],
                         Request if port else JaxRequest)
        olmoe["runs"][key] = streams, engine.metrics.preemptions
    return olmoe["runs"][key]


@pytest.mark.parametrize("name", list(ENGINES))
def test_greedy_streams_match_the_reference_engine(olmoe, name):
    """Each engine against the reference's under the same settings. The
    preempting pool restores what an evicted request wrote otherwise
    than the reference does — prompt rows by prefill chunks and decoded
    rows by replayed decode steps, where the reference re-prefills both
    (a known difference, ROADMAP §C) — so the two engines preempt at
    other ticks (12 and 24 times here); on this trace the streams are
    equal all the same, on another they part (the next test)."""
    ref, ref_pre = _run(olmoe, name, port=False)
    out, pre = _run(olmoe, name, port=True)
    assert out == ref
    assert [len(out[r["uid"]]) for r in olmoe["trace"]] == [
        new for _, new in TRACE_SPEC]
    assert (pre > 0) == (ref_pre > 0) == (name == "preempting")


def test_the_reference_breaks_its_contracts_for_moe(olmoe):
    """What the reference does for MoE, which the port reproduces (the
    test above): per-slot computation is not batch-neighbour
    independent — a step routes every row of every slot, sentinels
    included, against shared expert capacity — so its hybrid schedule
    gives other streams than its sync one, and its preempting pool other
    streams than its ample pool. Unpaged ≡ paged still holds."""
    def ref(name):
        return _run(olmoe, name, port=False)[0]

    def parted(a, b):
        return sorted(u for u in a if a[u] != b[u])

    assert parted(ref("hybrid"), ref("sync")) == [2, 4]
    assert parted(ref("preempting"), ref("ample")) == [2, 3, 4, 5]
    assert ref("unpaged") == ref("hybrid")


def test_a_preempting_pool_parts_where_a_decoded_request_is_restored(olmoe):
    """The known difference, recorded so that it is not read as parity:
    on seed 1's draw of the trace the preempting pools' streams part.
    Both engines evict requests that had decoded; the port restores
    their decoded rows by replaying decode steps, the reference by
    re-prefilling them, so the two put other rows through the MoE in
    other ticks, and capacity couples those rows' routing to their
    neighbours'. (Dense layers compute each row alone: there the two
    restores differ only where a re-prefilled row selects other key
    blocks.)"""
    trace = _trace(olmoe["model"].cfg, 1)
    victims = {}
    streams = {}
    for port in (True, False):
        engine = _engine(olmoe, "preempting", port)
        real, seen = engine._preempt, victims.setdefault(port, [])

        def preempt(i, _e=engine, _real=real, _seen=seen):
            _seen.append(len(_e.slots[i].tokens_out))
            return _real(i)

        engine._preempt = preempt
        streams[port] = _drain(engine, trace, Request if port else JaxRequest)
    assert streams[True] != streams[False]
    assert max(victims[True]) > 1 and max(victims[False]) > 1


def test_qwen3_moe_streams_match_the_reference_engine():
    """qwen3-moe-235b's smoke widths (G = 4, 3 layers, the fused kernels'
    plain versions on layer 1 onward) through both engines."""
    cfg = _serve_smoke("qwen3-moe-235b-a22b")
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    rng = np.random.default_rng(1)
    trace = [dict(uid=u, prompt=[int(x) for x in rng.integers(
        1, cfg.vocab_size - 1, size=length)], max_new_tokens=new)
        for u, (length, new) in enumerate(TRACE_SPEC[:4])]
    kw = dict(batch_slots=3, max_len=MAX_LEN, eos_token=EOS,
              prefill_chunk=8)
    ref = _drain(JaxServeLoop(jmodel, jparams, **kw), trace, JaxRequest)
    out = _drain(ServeLoop(model, params, device="cpu", **kw), trace,
                 Request)
    assert out == ref


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
@pytest.mark.parametrize("method", ["decode_step", "prefill"])
def test_moe_serve_steps_make_no_host_sync(paged, method):
    """The MoE block's routing, dispatch and combine in a serve step:
    no op that reads a device value on the host or gives a
    data-dependent shape, so the step replays from a CUDA graph."""
    model = LMModel(_serve_smoke("olmoe-1b-7b"), device="cpu")
    params = model.init(seed=0)
    cache, pre, zero, dec, index = _filled(model, params, paged)
    inputs, idx = (dec, index) if method == "decode_step" else (pre, zero)
    with HostSyncGuard() as guard:
        logits, _ = getattr(model, method)(params, cache, inputs, idx)
    assert guard.seen == []
    assert torch.isfinite(logits).all()


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------


def test_an_moe_engine_serves_on_a_tensor_parallel_mesh(olmoe):
    """A lone engine on a ``(1, 2)`` mesh serves the MoE model: its pool
    split by KV head, its experts by the model axis (views of the stacked
    leaves), every layer through the expert-parallel path
    (``tests/test_torch_moe_ep.py`` holds its streams to the reference's
    mesh engine). What stays refused is a data axis > 1 inside one MoE
    call through the active mesh — the train step's per-row path
    (``moe.moe_rows``) takes it instead — and a lone engine on such a
    mesh (replicas take the data axis)."""
    model, params = olmoe["model"], olmoe["params"]
    calls = []
    real = moe.apply_moe_sharded

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    kw = dict(batch_slots=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
              eos_token=EOS, device="cpu")
    moe.apply_moe_sharded = spy
    try:
        engine = ServeLoop(model, params, mesh=cpu_mesh(1, 2), **kw)
        streams = _drain(engine, olmoe["trace"][:3], Request)
    finally:
        moe.apply_moe_sharded = real
    assert [len(streams[u]) for u in range(3)] == [
        new for _, new in TRACE_SPEC[:3]]
    assert calls and len(calls) % model.cfg.num_layers == 0
    ep = engine.params["blocks"]["moe"]
    assert isinstance(ep["w_up"], tuple) and len(ep["w_up"]) == 2
    assert ep["w_up"][0].untyped_storage().data_ptr() == \
        params["blocks"]["moe"]["w_up"].untyped_storage().data_ptr()
    assert isinstance(engine.cache["k"], tuple)
    with pytest.raises(ValueError, match="TP-only mesh"):
        ServeLoop(model, params, mesh=cpu_mesh(2, 2), **kw)
    x = torch.zeros((1, 4, model.cfg.d_model))
    layer = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    with shd.active_mesh(cpu_mesh(2, 2)):
        with pytest.raises(ValueError, match="ZeRO all-gathers"):
            moe.apply_moe(layer, x, model._moe_cfg())


def test_the_launcher_serves_an_moe_model_on_a_mesh(capsys):
    """``--mesh 1x2 --simulate-devices 2`` serves olmoe (smoke widths, on
    the CPU) through one expert-parallel, tensor-parallel engine, and
    ``--mesh 2x2`` through two such replicas."""
    from repro_torch.launch import serve

    for spec, replicas in (("1x2", ""), ("2x2", ", 2 engine replicas")):
        serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                    "--mesh", spec, "--simulate-devices", "4",
                    "--requests", "2", "--new-tokens", "2",
                    "--prompt-len", "6"])
        out = capsys.readouterr().out
        d, m = spec.split("x")
        assert f"[serve] mesh {d}x{m} (data x model) over 1 physical cpu " \
               f"device(s){replicas}" in out


@pytest.mark.parametrize("slots", [1, 2])
def test_replicas_on_a_data_mesh_serve_moe(olmoe, slots):
    """``ReplicatedServeLoop`` on a ``(2, 1)`` mesh (model axis 1: the
    single-device path in both packages) gives the reference's replicated
    streams. With one slot an engine no request has neighbours, and the
    replicas give the single engine's streams too; with two they need
    not (capacity couples a replica's slots, as it does the single
    engine's), and do not on this trace."""
    kw = dict(batch_slots=slots, max_len=MAX_LEN, eos_token=EOS,
              prefill_chunk=8)
    port = _drain(ReplicatedServeLoop(olmoe["model"], olmoe["params"],
                                      mesh=cpu_mesh(2, 1), device="cpu",
                                      **kw), olmoe["trace"], Request)
    ref = _drain(JaxReplicated(olmoe["jmodel"], olmoe["jparams"],
                               replicas=2, **kw), olmoe["trace"],
                 JaxRequest)
    single = _drain(ServeLoop(olmoe["model"], olmoe["params"], device="cpu",
                              **kw), olmoe["trace"], Request)
    assert port == ref
    assert (port == single) == (slots == 1)

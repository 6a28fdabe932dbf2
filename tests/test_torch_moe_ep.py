"""Expert parallelism — ``models/moe.py::apply_moe_sharded``, the expert
shards of ``distributed/sharding.py`` and MoE engines on ``(data,
model)`` meshes — in the port against the reference, on the CPU.

The reference's expert-parallel layer (``_apply_moe_sharded``) needs a
mesh of several devices, so it runs in one subprocess a module under
``--xla_force_host_platform_device_count=4`` (as
``tests/test_distributed.py`` runs its meshes); inputs and results pass
as ``.npz`` / JSON files.

* The layer on ``cpu × M`` (M 2, 4) against JAX ``apply_moe`` under a
  ``(1, M)`` mesh, at capacity factors that drop (0.25) and that do not
  (8.0): each shard's experts, positions and keep exactly (against the
  reference's shard-local stages, the same JAX ops), the f32 output at
  ``LAYER_TOL``, aux and drop as ``test_torch_moe.py::_check_layer``.
* The bf16 cross-shard sum bit for bit against the reference's ``psum``
  over 'model' on the same per-shard partials (M 2, 4): the f32 sum of
  the shards' bf16 values, rounded once — not a chain of bf16 adds.
* The single-device path stays put: a model axis that does not divide
  the experts (M 3 on 8), and a ``(2, 1)`` mesh, give the port's own
  single-device layer bit for bit; a data axis > 1 inside one call
  through the active (serving) mesh is refused, naming the train
  step's path that takes it.
* Placement: on ``cpu × M`` the expert shards are views of the stacked
  leaves (one storage), the router stays whole; on another device a
  shard is a copy of its experts alone.
* Engines on the bf16 olmoe smoke model: the greedy streams of the
  port's ``ServeLoop`` on ``(1, 2)`` and ``(1, 4)`` meshes equal the
  reference engines' on the same meshes, and differ from the
  single-device streams (the expert-parallel path rounds otherwise).
  The ``(2, 2)`` replicas equal the reference's in fp32; in bf16 they
  part on one request, which the reference's own tensor parallelism
  explains: at G = 1 its mesh engine writes other K rows than its
  single-device engine in a dense model too, where the port's TP keeps
  the single-device bits (recorded below, ROADMAP §C). A qwen3-moe smoke
  engine on ``(1, 2)`` gives the reference's streams.

Tolerances: the f32 layer at atol = rtol = 1e-5 (``LAYER_TOL``: both
sides compute the same fp32 graph in other summation orders); integer
stages, the bf16 sum, the single-device path and streams exactly."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LMModel as JaxLMModel
from repro.models import moe as jmoe
from repro_torch.configs import registry
from repro_torch.convert import convert_params
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LMModel
from repro_torch.models import moe
from repro_torch.runtime import ReplicatedServeLoop, Request, ServeLoop
from tests._torch_port import jax_model_config, n, t
from tests.test_torch_moe import (
    LAYER_TOL, TRACE_SEED, TRACE_SPEC, _layer_case, _serve_smoke, _trace,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.join(os.path.dirname(__file__), "..")
MS = (2, 4)
FACTORS = {"drops": 0.25, "keeps": 8.0}
ENGINE_KW = dict(batch_slots=3, prefill_chunk=8, max_len=64, eos_token=-1)
#: (name, arch, dtype, mesh shape) of the engines run in both packages
ENGINES = (
    ("olmoe-bf16-1x2", "olmoe-1b-7b", "bfloat16", (1, 2)),
    ("olmoe-bf16-1x4", "olmoe-1b-7b", "bfloat16", (1, 4)),
    ("olmoe-bf16-2x2", "olmoe-1b-7b", "bfloat16", (2, 2)),
    ("olmoe-f32-2x2", "olmoe-1b-7b", "float32", (2, 2)),
    ("qwen3moe-bf16-1x2", "qwen3-moe-235b-a22b", "bfloat16", (1, 2)),
)

#: the reference's side, run once a module in a subprocess with four host
#: devices: the layer under (1, M) meshes, psum over 'model', the
#: engines, and its tensor-parallel cache at G = 1 (a dense model)
REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map_unchecked as shard_map
from repro.distributed import sharding as shd
from repro.launch.mesh import make_mesh_compat
from repro.models import LMModel, moe
from repro.runtime import ReplicatedServeLoop, Request, ServeLoop

inp, out_npz, out_json = sys.argv[1:4]
spec = json.loads(open(inp + ".json").read())
arrays = np.load(inp)
res, streams = {}, {}

def mesh(d, m):
    return make_mesh_compat((d, m), ("data", "model"))

def config(fields):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import EnergonConfig
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v
                     for k, v in d.items()}
    fields = tup(fields)
    fields["energon"] = EnergonConfig(**tup(fields["energon"]))
    return ModelConfig(**fields)

# the layer under (1, M) meshes
for case in spec["layers"]:
    cfg = moe.MoEConfig(**case["cfg"])
    p = {k: jnp.asarray(arrays[case["name"] + "/" + k])
         for k in ("router", "w_up", "w_gate", "w_down")}
    shd.set_active_mesh(mesh(1, case["m"]))
    try:
        out, met = moe.apply_moe(p, jnp.asarray(arrays[case["name"] + "/x"]),
                                 cfg)
    finally:
        shd.set_active_mesh(None)
    res[case["name"] + "/out"] = np.asarray(out)
    res[case["name"] + "/aux"] = np.asarray(met["moe_aux_loss"])
    res[case["name"] + "/drop"] = np.asarray(met["moe_drop_fraction"])

# psum over 'model' of bf16 partials
for m in spec["psum"]:
    parts = jnp.asarray(arrays[f"psum{m}"]).astype(jnp.bfloat16)
    summed = shard_map(lambda a: jax.lax.psum(a[0], "model"), mesh=mesh(1, m),
                       in_specs=(P("model"),), out_specs=P())(parts)
    res[f"psum{m}"] = np.asarray(summed.astype(jnp.float32))

# engines
from tests._torch_port import jax_model_config
for name, cfg_fields, shape in spec["engines"]:
    cfg = jax_model_config(config(cfg_fields))
    model = LMModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    kw = spec["engine_kw"]
    if shape[0] > 1:
        eng = ReplicatedServeLoop(model, params, mesh=mesh(*shape), **kw)
    else:
        eng = ServeLoop(model, params, mesh=mesh(*shape), **kw)
    for r in spec["trace"][cfg.name]:
        eng.submit(Request(**r))
    eng.run_until_drained()
    streams[name] = {str(r.uid): [int(x) for x in r.tokens_out]
                     for r in eng.completed}

# the reference's TP at G = 1: one prefill wave of a dense MHA model,
# single device against a (1, 2) mesh
cfg = jax_model_config(config(spec["dense_mha"]))
model = LMModel(cfg)
params = model.init(jax.random.PRNGKey(0))
caches = []
for m in (None, mesh(1, 2)):
    eng = ServeLoop(model, params, mesh=m, **spec["engine_kw"])
    for r in spec["trace"]["dense-mha"]:
        eng.submit(Request(**r))
    eng.tick()
    caches.append(np.asarray(eng.cache["k"]))
streams["dense_mha_k_mismatch_per_layer"] = [
    int((caches[0][l] != caches[1][l]).sum())
    for l in range(caches[0].shape[0])]
np.savez(out_npz, **res)
open(out_json, "w").write(json.dumps(streams))
print("ok")
"""


def cpu_mesh(d, m):
    return make_mesh((d, m), ("data", "model"), ["cpu"] * (d * m))


def _engine_cfg(arch, dtype):
    return dataclasses.replace(_serve_smoke(arch), dtype=dtype)


def _dense_mha_cfg():
    """olmoe's serve-smoke widths made dense: 4 / 4 heads of 16 (G 1)."""
    return dataclasses.replace(_serve_smoke("olmoe-1b-7b"), family="dense",
                               num_experts=0, experts_per_token=0,
                               name="dense-mha")


def _layer_cases():
    """(name, port cfg, numpy params, x) for each M × capacity factor at
    the olmoe smoke widths (8 experts top-2), inputs clear of ties."""
    cases = []
    for m in MS:
        for tag, factor in FACTORS.items():
            cfg, _, np_params, x = _layer_case("olmoe-1b-7b", factor,
                                               seed=m)
            cases.append((f"m{m}-{tag}", m, cfg, np_params, x))
    return cases


def _psum_partials(m, seed=11, rows=64, d=64):
    """bf16-valued partials [M, rows, d] spread over 2^±12, so that a
    chain of bf16 adds would round otherwise than one f32 sum."""
    rng = np.random.default_rng(seed + m)
    mag = rng.standard_normal((m, rows, d)) * 2.0 ** rng.integers(
        -12, 13, size=(m, rows, d))
    return torch.from_numpy(mag.astype(np.float32)).bfloat16().float().numpy()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results for every case of this module."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    arrays, layers = {}, []
    for name, m, cfg, np_params, x in _layer_cases():
        for k, v in np_params.items():
            arrays[f"{name}/{k}"] = v
        arrays[f"{name}/x"] = x
        layers.append(dict(name=name, m=m, cfg=dataclasses.asdict(cfg)))
    for m in MS:
        arrays[f"psum{m}"] = _psum_partials(m)
    engines = [(name, dataclasses.asdict(_engine_cfg(arch, dt)),
                list(shape)) for name, arch, dt, shape in ENGINES]
    trace = {registry.get_config(arch).name: _trace(
        _engine_cfg(arch, "float32"), TRACE_SEED)
        for arch in ("olmoe-1b-7b", "qwen3-moe-235b-a22b")}
    trace["dense-mha"] = _trace(_dense_mha_cfg(), TRACE_SEED)
    spec = dict(layers=layers, psum=list(MS), engines=engines,
                engine_kw=ENGINE_KW, trace=trace,
                dense_mha=dataclasses.asdict(_dense_mha_cfg()))
    inp = str(tmp / "in.npz")
    np.savez(inp, **arrays)
    with open(inp + ".json", "w") as f:
        f.write(json.dumps(spec))
    out_npz, out_json = str(tmp / "out.npz"), str(tmp / "out.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, ROOT])
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), inp, out_npz,
         out_json], capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out_json) as f:
        streams = json.load(f)
    return dict(np.load(out_npz)), streams


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------


def _reference_shard_routing(np_params, x, jcfg, m, s):
    """The shard-local integer stages of ``_apply_moe_sharded``
    (moe.py:254-276) for shard s of m, which the function does not
    return: the same JAX ops."""
    e, k = jcfg.num_experts, jcfg.experts_per_token
    e_local = e // m
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32),
                        jnp.asarray(np_params["router"]))
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    local_e = top_e - s * e_local
    mine = jnp.logical_and(local_e >= 0, local_e < e_local)
    flat_e = jnp.where(mine, local_e, e_local).reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e_local + 1, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    flat_pos = jnp.sum(pos * onehot, axis=-1)
    capacity = max(1, int(xt.shape[0] * k / e * jcfg.capacity_factor))
    keep = jnp.logical_and(flat_e < e_local, flat_pos < capacity)
    return (np.asarray(jnp.where(keep, flat_e, 0)),
            np.asarray(jnp.where(keep, flat_pos, 0)), np.asarray(keep))


@pytest.mark.parametrize("tag", FACTORS)
@pytest.mark.parametrize("m", MS)
def test_sharded_layer_matches_the_reference(ref, m, tag):
    res, _ = ref
    name, _, cfg, np_params, x = next(c for c in _layer_cases()
                                      if c[0] == f"m{m}-{tag}")
    jcfg = jmoe.MoEConfig(**dataclasses.asdict(cfg))
    params = {k: t(v) for k, v in np_params.items()}
    xt = t(x.reshape(-1, x.shape[-1]))
    _, _, top_e, flat_pos, keep, cap = moe.route(params, xt, cfg)
    kept = 0
    for s in range(m):
        safe_e, safe_pos, keep_s = moe.shard_route(
            top_e.reshape(-1), flat_pos, keep, s, cfg.num_experts // m)
        r_e, r_pos, r_keep = _reference_shard_routing(np_params, x, jcfg, m,
                                                      s)
        np.testing.assert_array_equal(n(safe_e), r_e)
        np.testing.assert_array_equal(n(safe_pos), r_pos)
        np.testing.assert_array_equal(n(keep_s), r_keep)
        kept += int(r_keep.sum())
    assert kept == int(keep.sum())
    calls = []
    real = moe.apply_moe_sharded

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    moe.apply_moe_sharded = spy
    try:
        with shd.active_mesh(cpu_mesh(1, m)):
            out, met = moe.apply_moe(params, t(x), cfg)
    finally:
        moe.apply_moe_sharded = real
    assert calls == [1]
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(n(out), res[f"{name}/out"], **LAYER_TOL)
    np.testing.assert_allclose(float(met["moe_aux_loss"]),
                               float(res[f"{name}/aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["moe_drop_fraction"]),
                               float(res[f"{name}/drop"]), rtol=1e-6)
    assert (float(met["moe_drop_fraction"]) > 0) == (tag == "drops")


@pytest.mark.parametrize("m", MS)
def test_bf16_cross_shard_sum_is_the_reference_psum(ref, m):
    """The f32 sum of the shards' bf16 partials rounded once: bit for bit
    the reference's ``psum`` over 'model'. A chain of bf16 adds is the
    same at M = 2 (two bf16 values add exactly in f32), not at M = 4."""
    res, _ = ref
    parts = torch.from_numpy(_psum_partials(m)).bfloat16()
    out = moe.cross_shard_sum(list(parts), torch.bfloat16,
                              torch.device("cpu"))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(out.float()), res[f"psum{m}"])
    chain = parts[0]
    for p in parts[1:]:
        chain = chain + p
    assert torch.equal(chain, out) == (m == 2)


def test_a_nan_expert_spreads_through_its_shard_s_gathers():
    """Expert 0's output NaN on a ``(1, 2)`` mesh (shard 0 holds experts
    0–3): on shard 0 every assignment it does not keep for experts 1–3
    — kept for expert 0, dropped, or another shard's — gathers local
    expert 0's row 0 (at weight 0 where not kept) and spreads the NaN,
    as the reference's shard-local gather does (moe.py:286-288); so a
    token stays finite only if shard 0 keeps all its assignments for
    experts 1–3. The single-device layer spreads it otherwise (only the
    tokens routed to expert 0)."""
    cfg, _, np_params, x = _layer_case("olmoe-1b-7b", 0.25)
    np_params["w_down"][0, 0, :] = np.nan
    params = {k: t(v) for k, v in np_params.items()}
    with shd.active_mesh(cpu_mesh(1, 2)):
        out, _ = moe.apply_moe(params, t(x), cfg)
    single, _ = moe.apply_moe(params, t(x), cfg)
    d = x.shape[-1]
    _, _, top_e, _, keep, _ = moe.route(params, t(x.reshape(-1, d)), cfg)
    k = cfg.experts_per_token
    clean = (keep & (top_e.reshape(-1) >= 1) & (top_e.reshape(-1) < 4)
             ).view(-1, k).all(-1)
    nan_rows = torch.isnan(out.reshape(-1, d)).all(-1)
    assert torch.equal(nan_rows, ~clean)
    assert torch.isfinite(out.reshape(-1, d)[clean]).all()
    assert bool(clean.any()) and bool((~clean).any())
    assert not torch.equal(nan_rows,
                           torch.isnan(single.reshape(-1, d)).all(-1))


@pytest.mark.parametrize("shape", [(1, 3), (2, 1)], ids=["m3", "data2"])
def test_the_single_device_path_stays_put(shape):
    cfg, _, np_params, x = _layer_case("olmoe-1b-7b", 1.25)
    params = {k: t(v) for k, v in np_params.items()}
    want, want_m = moe.apply_moe(params, t(x), cfg)
    with shd.active_mesh(cpu_mesh(*shape)):
        out, met = moe.apply_moe(params, t(x), cfg)
    assert torch.equal(out, want)
    assert torch.equal(met["moe_drop_fraction"], want_m["moe_drop_fraction"])
    assert torch.equal(met["moe_aux_loss"], want_m["moe_aux_loss"])


def test_a_data_axis_inside_one_call_is_refused():
    cfg, _, np_params, x = _layer_case("olmoe-1b-7b", 1.25)
    params = {k: t(v) for k, v in np_params.items()}
    with shd.active_mesh(cpu_mesh(2, 2)):
        with pytest.raises(ValueError, match="_quantized_all_gather"):
            moe.apply_moe(params, t(x), cfg)
    # expert shards outside their mesh
    shards = {k: v if k == "router" else (v[:4], v[4:])
              for k, v in params.items()}
    with pytest.raises(ValueError, match="serve mesh active"):
        moe.apply_moe(shards, t(x), cfg)


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m", MS)
def test_expert_shards_are_views_on_one_device(m):
    model = LMModel(_serve_smoke("olmoe-1b-7b"), device="cpu")
    params = model.init(seed=0)
    placed = shd.shard_experts(params, cpu_mesh(1, m))
    moe_p, got = params["blocks"]["moe"], placed["blocks"]["moe"]
    assert got["router"] is moe_p["router"]
    assert placed["embed"] is params["embed"]
    per = model.cfg.num_experts // m
    for name in ("w_up", "w_gate", "w_down"):
        leaf = moe_p[name]
        assert isinstance(got[name], tuple) and len(got[name]) == m
        for s, shard in enumerate(got[name]):
            assert shard.untyped_storage().data_ptr() == \
                leaf.untyped_storage().data_ptr()
            assert torch.equal(shard, leaf[:, s * per:(s + 1) * per])
            # each layer's slice is contiguous: the bmm reads it in place
            assert all(shard[i].is_contiguous()
                       for i in range(shard.shape[0]))
    # a model axis that does not divide the experts keeps them whole
    assert shd.shard_experts(params, cpu_mesh(1, 3)) is params
    assert shd.expert_shards(8, cpu_mesh(1, 3)) == 1
    assert shd.expert_shards(8, cpu_mesh(2, 1)) == 1
    assert shd.expert_shards(8, cpu_mesh(1, m)) == m


def test_an_expert_shard_on_another_device_is_a_copy_of_its_experts():
    """The meta device stands in for a second card: the shard placed
    there is a fresh ``[L, E/M, …]`` leaf, not a view of the whole."""
    model = LMModel(_serve_smoke("olmoe-1b-7b"), device="cpu")
    params = model.init(seed=0)
    mesh = make_mesh((1, 2), ("data", "model"), ["cpu", "meta"])
    got = shd.shard_experts(params, mesh)["blocks"]["moe"]["w_up"]
    leaf = params["blocks"]["moe"]["w_up"]
    assert got[0].device.type == "cpu" and got[1].device.type == "meta"
    assert got[1].shape == (leaf.shape[0], leaf.shape[1] // 2) + tuple(
        leaf.shape[2:])
    assert got[1].is_contiguous()


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------


class _Models(dict):
    """(arch, dtype) → the port's model and the reference's init carried
    across (PRNGKey 0, as the subprocess's), built on first use."""

    def __missing__(self, key):
        cfg = _engine_cfg(*key)
        jparams = JaxLMModel(jax_model_config(cfg)).init(
            jax.random.PRNGKey(0))
        model = LMModel(cfg, device="cpu")
        self[key] = model, convert_params(jax.tree.map(np.asarray, jparams),
                                          model)
        return self[key]


@pytest.fixture(scope="module")
def models():
    return _Models()


def _drain(engine, trace):
    for r in trace:
        engine.submit(Request(**r))
    engine.run_until_drained()
    return {r.uid: list(r.tokens_out) for r in engine.completed}


def _port_streams(models, arch, dt, shape):
    model, params = models[arch, dt]
    trace = _trace(model.cfg, TRACE_SEED)
    if shape is None:
        return _drain(ServeLoop(model, params, device="cpu", **ENGINE_KW),
                      trace)
    mesh = cpu_mesh(*shape)
    if shape[0] > 1:
        return _drain(ReplicatedServeLoop(model, params, mesh=mesh,
                                          device="cpu", **ENGINE_KW), trace)
    return _drain(ServeLoop(model, params, mesh=mesh, device="cpu",
                            **ENGINE_KW), trace)


def _ref_streams(streams, name):
    return {int(u): v for u, v in streams[name].items()}


@pytest.mark.parametrize("name", ["olmoe-bf16-1x2", "olmoe-bf16-1x4",
                                  "olmoe-f32-2x2", "qwen3moe-bf16-1x2"])
def test_ep_engine_streams_match_the_reference(ref, models, name):
    _, streams = ref
    _, arch, dt, shape = next(e for e in ENGINES if e[0] == name)
    calls = []
    real = moe.apply_moe_sharded

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    moe.apply_moe_sharded = spy
    try:
        out = _port_streams(models, arch, dt, shape)
    finally:
        moe.apply_moe_sharded = real
    assert out == _ref_streams(streams, name)
    assert [len(out[u]) for u in sorted(out)] == [
        new for _, new in TRACE_SPEC]
    assert calls    # the expert-parallel layer ran


def test_bf16_ep_streams_are_not_the_single_device_ones(models):
    """The expert-parallel path rounds each shard's partial to bf16
    before the cross-shard sum, so its streams part from the
    single-device engine's — in the reference as in the port (the
    reference's, above, are the mesh engines')."""
    single = _port_streams(models, "olmoe-1b-7b", "bfloat16", None)
    for shape in ((1, 2), (1, 4)):
        assert _port_streams(models, "olmoe-1b-7b", "bfloat16",
                             shape) != single


def test_bf16_replicas_part_where_the_reference_tp_parts(ref, models):
    """``(2, 2)`` replicas in bf16: the port's equal the reference's on
    every request but uid 1, which replica 1 serves beside uids 2–5. The
    reference's tensor parallelism explains it: on this model's widths
    (G = 1) its mesh engine writes other K rows than its single-device
    one, in a dense model too (one prefill wave: layer 0 alike, layers 1
    and 2 not), where the port's TP keeps the single-device bits
    (``test_torch_mesh.py``); here that shift flips one token of uid 1.
    Each replica still gives what a lone ``(1, 2)`` engine gives on its
    requests."""
    _, streams = ref
    model, params = models["olmoe-1b-7b", "bfloat16"]
    out = _port_streams(models, "olmoe-1b-7b", "bfloat16", (2, 2))
    want = _ref_streams(streams, "olmoe-bf16-2x2")
    assert sorted(u for u in out if out[u] != want[u]) == [1]
    k_mismatch = streams["dense_mha_k_mismatch_per_layer"]
    assert k_mismatch[0] == 0 and all(c > 0 for c in k_mismatch[1:])
    trace = _trace(model.cfg, TRACE_SEED)
    eng = ReplicatedServeLoop(model, params, mesh=cpu_mesh(2, 2),
                              device="cpu", **ENGINE_KW)
    for r in trace:
        eng.submit(Request(**r))
    for r in range(2):
        mine = [q for q in trace if eng.placement[q["uid"]] == r]
        lone = _drain(ServeLoop(model, params, mesh=cpu_mesh(1, 2),
                                device="cpu", **ENGINE_KW), mine)
        assert lone == {u: out[u] for u in lone}

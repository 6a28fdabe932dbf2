"""``distributed/compression.py``, ``distributed/elastic.py`` and
resuming a mesh run on another mesh, on the CPU, against the reference.

* Compression: ``compress`` / ``decompress`` equal the reference's on
  the same gradient and error (codes and scale bit for bit, the error to
  the last bit of f32); ``compressed_psum_shard_map`` over a data axis
  of 4 equals the reference's on a ``(4,)`` mesh of host devices (one
  subprocess) step by step over the telescoping run of
  ``tests/test_distributed.py::test_error_feedback_telescopes``, and the
  port's run passes that test's bounds (one step within 2 %, the error
  feedback's drift below one step's error).
* Elastic: ``reshard_params`` / ``gather_params`` round trip bit for bit
  on ``(1, 1)`` and ``(2, 2)``; ``mesh_fingerprint`` and
  ``validate_elastic_resume`` give the reference's strings and verdicts.
* A ``TrainLoop`` on a ``(2, 2)`` mesh writes its checkpoint with the
  logical arrays and the mesh's fingerprint; loops on ``(1, 1)``, ``(4,
  1)`` and one device restore bit-equal logical state from it, and the
  resumed mesh run's next steps equal the uninterrupted run's. The same
  across ``(2, 2, 2)`` ``(pod, data, model)`` ↔ ``(1, 1)`` / ``(4, 1)``,
  with the reference's fingerprint strings; a pod mesh's loop equals
  the ``(4, 2)`` loop.
* The reference's GPipe case (``tests/test_distributed.py``) and
  ``_apply_moe_serve_2d`` on ``(2, 2)`` / ``(1, 4)`` in f32 and bf16,
  run in the same 4-device subprocess as the telescoping run, against
  the port's ``pipeline_forward`` and ``apply_moe_serve_2d``; the
  port's pipeline over a smoke qwen3 stack ≡ ``apply_stack``.
* ``python -m repro_torch.launch.train --smoke --device cpu --mesh 2x2
  --simulate-devices 4`` runs, and ``--model-axis 2`` with four
  simulated devices trains on a ``(2, 2)`` mesh.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro.distributed import elastic as jelastic
from repro_torch.checkpoint import list_checkpoints, step_dir
from repro_torch.configs import registry
from repro_torch.data import TokenDataset
from repro_torch.distributed import compression as comp
from repro_torch.distributed import elastic
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LMModel
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.runtime import TrainConfig, TrainLoop
from repro_torch.runtime.train_loop import gather_state
from tests._torch_port import t

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS = 25


def cpu_mesh(d, m):
    return make_mesh((d, m), devices=["cpu"] * (d * m))


def _gradient():
    return np.random.default_rng(0).normal(size=(128,)).astype(np.float32)


#: the 2-D expert layer's cases: (dtype, batch, mesh shape); batch 4
#: divides the data axis (the reference gathers the tokens), batch 1
#: does not (it replicates them)
SERVE_2D_CASES = [(dt, b, shape) for dt in ("float32", "bfloat16")
                  for b in (4, 1) for shape in ((2, 2), (1, 4))]
SERVE_2D_LAYER = dict(num_experts=8, experts_per_token=2, d_model=32,
                      d_ff=16, capacity_factor=1.25)


@pytest.fixture(scope="module")
def ref4(tmp_path_factory):
    """The reference on four host devices, in one subprocess: the
    telescoping run on a (4,) data mesh (each step's compressed sum),
    ``tests/test_distributed.py``'s GPipe case on a ``(4,)`` pod mesh
    with numpy weights, and ``_apply_moe_serve_2d`` (``apply_moe`` under
    the ``"serve"`` profile) on ``(2, 2)`` and ``(1, 4)`` meshes."""
    out = tmp_path_factory.mktemp("ref4") / "ref4.npz"
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import numpy as np, jax, jax.numpy as jnp
        from repro.distributed import compression as comp
        from repro.distributed import sharding as shd
        from repro.distributed.pipeline import (
            pipeline_forward, split_layers_to_stages)
        from repro.launch.mesh import make_mesh_compat
        from repro.models import moe as M
        arrays = {{}}
        mesh = make_mesh_compat((4,), ("data",))
        g = jnp.asarray(np.random.default_rng(0).normal(size=(128,))
                        .astype(np.float32))
        err = jnp.zeros_like(g)
        sums = []
        for _ in range({STEPS}):
            s, (err,) = comp.compressed_psum_shard_map(
                (g,), (err,), mesh, ("data",))
            sums.append(np.asarray(s[0]))
        arrays["telescope"] = np.stack(sums)

        rng = np.random.default_rng(7)
        L, d = 8, 16
        ws = (rng.normal(size=(L, d, d)) * d ** -0.5).astype(np.float32)
        mb = rng.normal(size=(6, 3, d)).astype(np.float32)
        def stage_fn(params, x):
            y, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x,
                                params)
            return y
        out = pipeline_forward(stage_fn, split_layers_to_stages(
            jnp.asarray(ws), 4), jnp.asarray(mb),
            make_mesh_compat((4,), ("pod",)), axis="pod")
        arrays.update({{"gpipe/ws": ws, "gpipe/mb": mb,
                        "gpipe/out": np.asarray(out)}})

        cfg = M.MoEConfig(**{SERVE_2D_LAYER!r})
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        rng = np.random.default_rng(8)
        p = {{"router": rng.normal(size=(d, e)) * d ** -0.5,
              "w_up": rng.normal(size=(e, d, f)) * d ** -0.5,
              "w_gate": rng.normal(size=(e, d, f)) * d ** -0.5,
              "w_down": rng.normal(size=(e, f, d)) * f ** -0.5}}
        p = {{k: v.astype(np.float32) for k, v in p.items()}}
        arrays.update({{"moe/p/" + k: v for k, v in p.items()}})
        for b in (4, 1):
            arrays[f"moe/x{{b}}"] = rng.normal(size=(b, 8, d)).astype(
                np.float32)
        for dt, b, shape in {SERVE_2D_CASES!r}:
            jp = {{k: jnp.asarray(v) if k == "router"
                   else jnp.asarray(v).astype(dt) for k, v in p.items()}}
            shd.set_rules_profile("serve")
            shd.set_active_mesh(make_mesh_compat(shape, ("data", "model")))
            o, met = jax.jit(lambda p, x: M.apply_moe(p, x, cfg))(
                jp, jnp.asarray(arrays[f"moe/x{{b}}"]).astype(dt))
            shd.set_active_mesh(None)
            shd.set_rules_profile("train")
            key = f"moe/{{dt}}/{{b}}/{{shape[0]}}x{{shape[1]}}"
            arrays[key + "/out"] = np.asarray(o.astype(jnp.float32))
            arrays[key + "/aux"] = np.asarray(met["moe_aux_loss"])
            arrays[key + "/drop"] = np.asarray(met["moe_drop_fraction"])
        np.savez({str(out)!r}, **arrays)
        print("done")
        """)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def telescoping_ref(ref4):
    return ref4["telescope"]


def test_compress_equals_the_reference():
    rng = np.random.default_rng(1)
    g = rng.normal(size=(256,)).astype(np.float32)
    err = (rng.normal(size=(256,)) * 1e-3).astype(np.float32)
    codes, scale, new_err = comp.compress(t(g), t(err))
    jcodes, jscale, jerr = jcomp.compress(jnp.asarray(g), jnp.asarray(err))
    assert codes.dtype == torch.int8
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    assert float(scale) == float(jscale)
    np.testing.assert_allclose(new_err.numpy(), np.asarray(jerr), rtol=0,
                               atol=1e-7)
    recon = comp.decompress(codes, scale)
    np.testing.assert_array_equal(
        recon.numpy(), np.asarray(jcomp.decompress(jcodes, jscale)))
    # the reference's round-trip bound
    np.testing.assert_allclose((recon + new_err).numpy(), g + err, atol=1e-6)
    zeros = comp.init_error_state({"a": t(g), "b": (t(err),)})
    assert torch.equal(zeros["b"][0], torch.zeros(256))


def test_compressed_psum_telescopes_as_the_reference(telescoping_ref):
    g = t(_gradient())
    mesh = cpu_mesh(4, 1)
    err = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for i in range(STEPS):
        s, (err,) = comp.compressed_psum_shard_map((g,), (err,), mesh,
                                                   ("data",))
        np.testing.assert_allclose(s[0].numpy(), telescoping_ref[i],
                                   rtol=1e-6, atol=1e-6, err_msg=str(i))
        acc = acc + s[0]
    exact = STEPS * 4.0 * g
    drift = float((acc - exact).abs().max() / exact.abs().max())
    one, _ = comp.compressed_psum_shard_map((g,), (torch.zeros_like(g),),
                                            mesh)
    one_err = float((one[0] - 4 * g).abs().max() / (4 * g).abs().max())
    assert one_err < 0.02
    assert drift < one_err
    # per-row gradients: each row's own compressed values, summed
    rows = [{"w": g * (r + 1)} for r in range(3)]
    sums, errs = comp.compressed_psum(rows, [{"w": torch.zeros_like(g)}] * 3)
    assert all(torch.equal(s["w"], sums[0]["w"]) for s in sums)
    np.testing.assert_allclose(sums[0]["w"].numpy(), (6 * g).numpy(),
                               atol=0.02 * float((6 * g).abs().max()))
    assert [e["w"].shape for e in errs] == [g.shape] * 3


class _RefMesh:
    """What the reference's fingerprint reads: axis names and the device
    grid's shape."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.devices = np.empty(shape, dtype=object)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 2)])
def test_elastic_round_trip_and_fingerprints(shape):
    params = {"w": np.random.default_rng(0).normal(size=(8, 4)).astype(
        np.float32), "blocks": {"mlp": {"w_up": np.arange(
            2 * 8 * 6, dtype=np.float32).reshape(2, 8, 6)}}}
    mesh = cpu_mesh(*shape)
    placed = elastic.reshard_params(params, mesh)
    assert isinstance(placed["blocks"]["mlp"]["w_up"], shd.ShardedLeaf)
    back = elastic.gather_params(placed)
    np.testing.assert_array_equal(back["w"], params["w"])
    np.testing.assert_array_equal(back["blocks"]["mlp"]["w_up"],
                                  params["blocks"]["mlp"]["w_up"])
    fp = elastic.mesh_fingerprint(mesh)
    assert fp == jelastic.mesh_fingerprint(_RefMesh(shape))
    assert elastic.mesh_fingerprint(None) == jelastic.mesh_fingerprint(None)
    for old in ("data=1xmodel=1", "data=4xmodel=2", "unsharded"):
        assert elastic.validate_elastic_resume(back, old, mesh) == \
            jelastic.validate_elastic_resume(back, old, _RefMesh(shape))


def _loop(steps, mesh, ckpt_dir=None, every=200):
    cfg = registry.get_smoke_config("qwen3-14b")
    ds = TokenDataset(cfg.vocab_size, seq_len=32, global_batch=8, seed=0,
                      corpus_tokens=20000)
    tc = TrainConfig(total_steps=steps, log_every=1, checkpoint_dir=ckpt_dir,
                     checkpoint_every=every, num_microbatches=2,
                     optimizer=AdamWConfig(learning_rate=3e-3))
    return TrainLoop(LMModel(cfg, device="cpu"), tc, ds, mesh=mesh)


def _logical(loop, params, opt_state):
    if loop.mesh is not None:
        params, opt_state = gather_state(params, opt_state)
    return adamw.tree_leaves({"params": params, "mu": opt_state.mu,
                              "nu": opt_state.nu, "step": opt_state.step})


def test_a_mesh_checkpoint_resumes_bit_equal_on_other_meshes(tmp_path):
    first = _loop(2, cpu_mesh(2, 2), str(tmp_path), every=2).run()
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [2]
    with open(os.path.join(step_dir(str(tmp_path), 2), "manifest.json")) as f:
        assert json.load(f)["mesh"] == "data=2xmodel=2"
    saved = _logical(_loop(2, cpu_mesh(2, 2)), first["params"],
                     first["opt_state"])
    for mesh in (cpu_mesh(1, 1), cpu_mesh(4, 1), None):
        loop = _loop(4, mesh, str(tmp_path))
        params, opt, start = loop._init_state()
        assert start == 2 and loop.dataset.state == {"step": 2}
        got = _logical(loop, params, opt)
        assert [k for k, _ in got] == [k for k, _ in saved]
        for (key, a), (_, b) in zip(got, saved):
            assert torch.equal(a, b), (mesh, key)
    whole = _loop(4, cpu_mesh(2, 2)).run()
    out = _loop(4, cpu_mesh(2, 2), str(tmp_path)).run()
    assert out["final_step"] == 4
    assert [h["loss"] for h in out["history"]] == [
        h["loss"] for h in whole["history"][2:]]


def test_the_train_launcher_runs_on_a_simulated_mesh(capsys):
    from repro_torch.launch import train

    result = train.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                         "--mesh", "2x2", "--simulate-devices", "4",
                         "--steps", "3", "--seq-len", "32",
                         "--global-batch", "4"])
    assert result["final_step"] == 3
    assert "on a 2x2 mesh of cpu: 3 steps" in capsys.readouterr().out
    table = result["params"]["embed"]["table"]
    assert isinstance(table, shd.ShardedLeaf) and table.spec == ("model",
                                                                 None)
    result = train.main(["--arch", "olmoe-1b-7b", "--smoke", "--device",
                         "cpu", "--model-axis", "2", "--simulate-devices",
                         "4", "--steps", "2", "--seq-len", "16",
                         "--global-batch", "4"])
    assert result["final_step"] == 2
    assert "on a 2x2 mesh of cpu: 2 steps" in capsys.readouterr().out


# --------------------------------------------------------------------------
# the (pod, data, model) mesh: fingerprints, elastic resume, checkpoints
# --------------------------------------------------------------------------


class _RefPodMesh(_RefMesh):
    def __init__(self, shape):
        super().__init__(shape)
        self.axis_names = ("pod", "data", "model")


def pod_mesh(p, d, m):
    return make_mesh((p, d, m), devices=["cpu"] * (p * d * m))


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 1, 4), (1, 2, 1)])
def test_pod_mesh_elastic_round_trip_and_fingerprints(shape):
    params = {"w": np.random.default_rng(1).normal(size=(8, 4)).astype(
        np.float32), "blocks": {"mlp": {"w_up": np.arange(
            2 * 8 * 8, dtype=np.float32).reshape(2, 8, 8)}}}
    mesh = pod_mesh(*shape)
    placed = elastic.reshard_params(params, mesh)
    up = placed["blocks"]["mlp"]["w_up"]
    assert up.spec == (None, "data", "model")
    # replicated over 'pod': each shard once, on pod 0's devices
    assert sorted(up.shards) == [(0, i, j) for i in range(shape[1])
                                 for j in range(shape[2])]
    back = elastic.gather_params(placed)
    np.testing.assert_array_equal(back["blocks"]["mlp"]["w_up"],
                                  params["blocks"]["mlp"]["w_up"])
    np.testing.assert_array_equal(back["w"], params["w"])
    fp = elastic.mesh_fingerprint(mesh)
    assert fp == jelastic.mesh_fingerprint(_RefPodMesh(shape))
    assert fp == "pod={}xdata={}xmodel={}".format(*shape)
    for old in ("data=2xmodel=2", fp, "unsharded"):
        assert elastic.validate_elastic_resume(back, old, mesh) == \
            jelastic.validate_elastic_resume(back, old, _RefPodMesh(shape))


@pytest.mark.parametrize("written,restored", [
    ((2, 2, 2), (1, 1)), ((2, 2, 2), (4, 1)), ((1, 1), (2, 2, 2)),
    ((4, 1), (2, 2, 2))], ids=["222-to-11", "222-to-41", "11-to-222",
                               "41-to-222"])
def test_a_pod_mesh_checkpoint_resumes_bit_equal(tmp_path, written,
                                                 restored):
    """A checkpoint written on a ``(2, 2, 2)`` mesh restores bit-equal on
    ``(1, 1)`` and ``(4, 1)``, and the reverse; the manifest holds the
    writer's fingerprint."""
    def mesh_of(shape):
        return pod_mesh(*shape) if len(shape) == 3 else cpu_mesh(*shape)

    first = _loop(2, mesh_of(written), str(tmp_path), every=2).run()
    with open(os.path.join(step_dir(str(tmp_path), 2), "manifest.json")) as f:
        assert json.load(f)["mesh"] == elastic.mesh_fingerprint(
            mesh_of(written))
    saved = _logical(_loop(2, mesh_of(written)), first["params"],
                     first["opt_state"])
    loop = _loop(4, mesh_of(restored), str(tmp_path))
    params, opt, start = loop._init_state()
    assert start == 2 and loop.dataset.state == {"step": 2}
    got = _logical(loop, params, opt)
    assert [k for k, _ in got] == [k for k, _ in saved]
    for (key, a), (_, b) in zip(got, saved):
        assert torch.equal(a, b), key


def test_pod_mesh_train_loop_equals_the_data_mesh_loop():
    """The same loop on ``(2, 2, 2)`` and on ``(4, 2)``: both split each
    microbatch over four data rows, and the pod axis only renames two of
    them, so the losses agree to the last bit of their f32 sums' order
    (rtol 1e-6)."""
    pod = _loop(3, pod_mesh(2, 2, 2)).run()
    flat = _loop(3, cpu_mesh(4, 2)).run()
    np.testing.assert_allclose([h["loss"] for h in pod["history"]],
                               [h["loss"] for h in flat["history"]],
                               rtol=1e-6)


# --------------------------------------------------------------------------
# the GPipe pipeline over 'pod'
# --------------------------------------------------------------------------


def _tanh_stage(params, x):
    for w in params:
        x = torch.tanh(x @ w)
    return x


def test_gpipe_equals_the_reference(ref4):
    """``tests/test_distributed.py``'s case (L 8, d 16, 4 stages, 6
    microbatches of 3) with the same numpy weights: the port's
    ``pipeline_forward`` on a ``(4,)`` pod mesh of ``cpu`` equals the
    reference's within that test's bound (1e-5: XLA's f32 tanh and dot
    against torch's), and its own sequential stack bit for bit."""
    from repro_torch.distributed.pipeline import (
        pipeline_forward, split_layers_to_stages)
    from repro_torch.launch.mesh import make_mesh as mk

    ws, mb = t(ref4["gpipe/ws"]), t(ref4["gpipe/mb"])
    mesh = mk((4,), ("pod",), ["cpu"] * 4)
    assert mesh.shape == {"pod": 4}
    stages = split_layers_to_stages(ws, 4)
    assert stages.shape == (4, 2, 16, 16)
    out = pipeline_forward(_tanh_stage, stages, mb, mesh, axis="pod")
    assert out.shape == mb.shape
    np.testing.assert_allclose(out.numpy(), ref4["gpipe/out"], atol=1e-5,
                               rtol=0)
    seq = torch.stack([_tanh_stage(ws, x) for x in mb])
    assert torch.equal(out, seq)


def test_split_layers_refuses_an_indivisible_stack():
    from repro_torch.distributed.pipeline import split_layers_to_stages

    tree = {"a": torch.zeros(6, 2), "b": (torch.zeros(6),)}
    got = split_layers_to_stages(tree, 3)
    assert got["a"].shape == (3, 2, 2) and got["b"][0].shape == (3, 2)
    with pytest.raises(ValueError, match="6 layers not divisible by 4"):
        split_layers_to_stages(tree, 4)


def test_pipeline_runs_the_ports_stack_as_apply_stack():
    """A smoke qwen3 stack of 4 layers (``impl="pallas"`` from layer 0:
    the plain B9 / B10 on the CPU) as 2 stages over a ``(2,)`` pod mesh,
    3 microbatches of ``[1, 32]`` hidden states: each stage
    ``transformer.apply_stack`` over its slab of the stacked blocks, the
    outputs bit for bit ``apply_stack`` of the 4 layers on each
    microbatch."""
    from repro_torch.distributed.pipeline import (
        pipeline_forward, split_layers_to_stages)
    from repro_torch.launch.mesh import make_mesh as mk
    from repro_torch.models import transformer as tfm

    cfg = registry.get_smoke_config("qwen3-14b")
    cfg = dataclasses.replace(cfg, num_layers=4, energon=dataclasses.replace(
        cfg.energon, impl="pallas", min_prune_layer=0, query_block=16,
        key_block=16))
    model = LMModel(cfg, device="cpu")
    params = model.init(seed=4)
    block_fn = model._tfm_block_fn()

    def stage_fn(slab, x):
        return tfm.apply_stack(slab, x, None, block_fn)[0]

    gen = torch.Generator().manual_seed(0)
    mb = torch.randn((3, 1, 32, cfg.d_model), generator=gen)
    with torch.no_grad():
        out = pipeline_forward(stage_fn, split_layers_to_stages(
            params["blocks"], 2), mb, mk((2,), ("pod",), ["cpu"] * 2))
        want = torch.stack([stage_fn(params["blocks"], x) for x in mb])
    assert torch.isfinite(out).all()
    assert torch.equal(out, want)


# --------------------------------------------------------------------------
# the "serve" profile's 2-D experts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,batch,shape", SERVE_2D_CASES,
                         ids=[f"{d}-b{b}-{s[0]}x{s[1]}"
                              for d, b, s in SERVE_2D_CASES])
def test_serve_2d_moe_equals_the_reference(ref4, dtype, batch, shape):
    """``apply_moe`` under the ``"serve"`` profile on a ``(2, 2)`` /
    ``(1, 4)`` mesh of ``cpu`` takes ``apply_moe_serve_2d`` and equals
    the reference's ``_apply_moe_serve_2d``: in bf16 bit for bit; in f32
    within 1e-5 (XLA's f32 dot and torch's differ in the last bits of
    each partial, so the f32 sum's order over the mesh cannot be read
    off: ROADMAP §C); the aux loss within 1e-6 relative, the drop
    fraction exactly."""
    from repro_torch.models import moe

    tdt = getattr(torch, dtype)
    cfg = moe.MoEConfig(**SERVE_2D_LAYER)
    p = {k: t(ref4["moe/p/" + k]) for k in ("router", "w_up", "w_gate",
                                             "w_down")}
    p = {k: v if k == "router" else v.to(tdt) for k, v in p.items()}
    x = t(ref4[f"moe/x{batch}"]).to(tdt)
    key = f"moe/{dtype}/{batch}/{shape[0]}x{shape[1]}"
    calls = []
    real = moe.apply_moe_serve_2d

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    shd.set_rules_profile("serve")
    moe.apply_moe_serve_2d = spy
    try:
        with shd.active_mesh(cpu_mesh(*shape)):
            out, met = moe.apply_moe(p, x, cfg)
    finally:
        moe.apply_moe_serve_2d = real
        shd.set_rules_profile("train")
    assert calls == [1] and out.dtype == tdt and out.shape == x.shape
    want = t(ref4[key + "/out"])
    if dtype == "bfloat16":
        assert torch.equal(out.float(), want)
    else:
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(float(met["moe_aux_loss"]),
                               float(ref4[key + "/aux"]), rtol=1e-6)
    assert float(met["moe_drop_fraction"]) == float(ref4[key + "/drop"])


def test_serve_2d_layout_and_refusals():
    """``shard_experts`` under the serve profile lays the experts out
    2-D on ``(2, 2)`` (M tuples of D d_ff slices, ``P("model", None,
    "data")`` for up / gate, ``P("model", "data", None)`` for down) and
    the layer on that layout equals the layer on whole leaves bit for
    bit; past 4096 tokens the serve profile takes the expert-parallel
    path; on a pod axis > 1 each pod sums its own partials (the pods are
    replicas), so the layer equals the one-pod layer bit for bit."""
    from repro_torch.models import moe

    cfg = moe.MoEConfig(**SERVE_2D_LAYER)
    params = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    stacked = {k: v[None] for k, v in params.items()}
    mesh = cpu_mesh(2, 2)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    shd.set_rules_profile("serve")
    try:
        tree = shd.shard_experts({"blocks": {"moe": stacked}}, mesh)
        lay = tree["blocks"]["moe"]
        assert lay["router"] is stacked["router"]
        assert len(lay["w_up"]) == 2 and len(lay["w_up"][0]) == 2
        assert torch.equal(lay["w_up"][1][0][0], params["w_up"][4:, :, :8])
        assert torch.equal(lay["w_down"][0][1][0], params["w_down"][:4, 8:])
        layer = {k: (tuple(tuple(p[0] for p in s) for s in v)
                     if isinstance(v, tuple) else v[0])
                 for k, v in lay.items()}
        with shd.active_mesh(mesh):
            got, _ = moe.apply_moe(layer, x, cfg)
            want, _ = moe.apply_moe(params, x, cfg)
            assert torch.equal(got, want)
            big = torch.zeros(1, moe.SERVE_2D_TOKENS + 1, cfg.d_model)
            seen = []
            real = moe.apply_moe_sharded
            moe.apply_moe_sharded = lambda *a, **kw: seen.append(1) or real(
                *a, **kw)
            try:
                moe.apply_moe(params, big, cfg)
            finally:
                moe.apply_moe_sharded = real
            assert seen == [1]
        one_pod, _ = moe.apply_moe_serve_2d(params, x, cfg,
                                            pod_mesh(1, 1, 2))
        two_pods, _ = moe.apply_moe_serve_2d(params, x, cfg,
                                             pod_mesh(2, 1, 2))
        assert torch.equal(two_pods, one_pod)
    finally:
        shd.set_rules_profile("train")

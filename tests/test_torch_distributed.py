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
  resumed mesh run's next steps equal the uninterrupted run's.
* ``python -m repro_torch.launch.train --smoke --device cpu --mesh 2x2
  --simulate-devices 4`` runs, and ``--model-axis 2`` with four
  simulated devices trains on a ``(2, 2)`` mesh.
"""

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


@pytest.fixture(scope="module")
def telescoping_ref():
    """The reference's telescoping run on a (4,) data mesh: each step's
    compressed sum."""
    prog = textwrap.dedent(f"""
        import os, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import numpy as np, jax, jax.numpy as jnp
        from repro.distributed import compression as comp
        from repro.launch.mesh import make_mesh_compat
        mesh = make_mesh_compat((4,), ("data",))
        g = jnp.asarray(np.random.default_rng(0).normal(size=(128,))
                        .astype(np.float32))
        err = jnp.zeros_like(g)
        sums = []
        for _ in range({STEPS}):
            s, (err,) = comp.compressed_psum_shard_map(
                (g,), (err,), mesh, ("data",))
            sums.append(np.asarray(s[0]).tolist())
        print(json.dumps({{"sums": sums}}))
        """)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    return np.asarray(json.loads(run.stdout.strip().splitlines()[-1])["sums"],
                      np.float32)


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

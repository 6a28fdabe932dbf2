"""Training runs on the port against the reference, on the CPU: the
train step, ``TrainLoop`` and the launchers.

* Three ``make_train_step`` steps with 1 and 2 microbatches from one
  state (a smoke model, ``mpmrf_row`` at ρ = 1): params, moments and
  metrics against the reference's step; the same steps on a ``(2, 2)``
  mesh of the CPU equal the one-device steps, and the launcher trains
  on a mesh (``--model-axis``).
* ``TrainLoop``: a resume from a checkpoint restores the saved state
  bit for bit and continues as the uninterrupted run; a requested
  preemption stops and saves; a tiny dense model's loss falls over 60
  steps and its trained weights serve through ``ServeLoop``.
* ``python -m repro_torch.launch.train`` and ``repro_torch.train_lm``
  on the CPU.

Tolerances: after three train steps the params agree within 2e-5, the
moments within rtol 1e-3 and the metrics within rtol 1e-4, on all but
0.1 % of each leaf's elements, and every param within 2·steps·lr: a
first AdamW step moves a weight by ≈ lr·sign(g), and a gradient near 0
may flip its sign on a last-bit difference (the gradients themselves
are held in ``test_torch_train.py``). Losses of one batch split in two
microbatches or not agree at rtol 1e-5. The CPU runs are
deterministic, so a resumed run equals the uninterrupted one exactly."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw as jadamw
from repro.runtime import make_train_step as jax_make_train_step
from repro_torch.checkpoint import list_checkpoints
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_opt_state, to_numpy_tree
from repro_torch.core import EnergonConfig
from repro_torch.data import TokenDataset
from repro_torch.models import LMModel
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.runtime import (
    Request, ServeLoop, TrainConfig, TrainLoop, make_train_step,
)
from tests.test_torch_train import _batch, _pair, _rho1


@pytest.mark.parametrize("micro", [1, 2])
def test_three_train_steps_match_the_reference(micro):
    cfg = _rho1(registry.get_smoke_config("qwen3-14b"))
    jmodel, jparams, model, params = _pair(cfg)
    opt_kw = dict(learning_rate=1e-3, clip_norm=1.0)
    jopt = JaxAdamWConfig(**opt_kw)
    jstate = jadamw.init(jparams, jopt)
    state = convert_opt_state(jax.tree.map(np.asarray, jstate), params)
    jstep = jax_make_train_step(jmodel, jopt, num_microbatches=micro,
                                donate=False)
    step = make_train_step(model, AdamWConfig(**opt_kw),
                           num_microbatches=micro)
    for i in range(3):
        batch = _batch(cfg, batch=4, seed=20 + i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    jax.tree.map(jnp.asarray, batch))
        params, state, m = step(params, state, batch)
        for key in ("loss", "grad_norm", "lr", "ce"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=key)
    lr = opt_kw["learning_rate"]
    # a first AdamW step moves each weight by ≈ lr·sign(g): a gradient
    # near 0 may flip its sign on last-bit differences
    _check_close(params, jparams, atol=2e-5, bound=2 * 3 * lr)
    _check_close(state.mu, jstate.mu, atol=1e-7, rtol=1e-3)
    _check_close(state.nu, jstate.nu, atol=1e-10, rtol=1e-3)
    assert int(state.step) == 3


def _check_close(port, ref, atol, rtol=0.0, bound=None, share=1e-3):
    """Each leaf within ``atol + rtol·|ref|`` but for at most ``share``
    of its elements, and every element within ``bound`` (default: the
    largest |ref|·rtol + atol, i.e. no exception)."""
    port = jax.tree.leaves(to_numpy_tree(port))
    ref = jax.tree.leaves(jax.tree.map(np.asarray, ref))
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        diff = np.abs(a - b)
        off = diff > atol + rtol * np.abs(b)
        assert off.mean() <= share, (off.sum(), diff.max())
        limit = bound if bound is not None else (
            atol + rtol * float(np.abs(b).max()))
        assert diff.max() <= limit, (diff.max(), limit)


def test_a_mesh_train_step_equals_the_one_device_step():
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.train_loop import gather_state, shard_state

    cfg = _rho1(registry.get_smoke_config("qwen3-14b"))
    model = LMModel(cfg, device="cpu")
    opt = AdamWConfig(learning_rate=1e-3)
    params = model.init(seed=0)
    state = adamw.init(params, opt)
    mesh = make_mesh((2, 2), devices=["cpu"] * 4)
    placed, placed_state = shard_state(model.init(seed=0),
                                       adamw.init(model.init(seed=0), opt),
                                       mesh)
    one = make_train_step(model, opt)
    sharded = make_train_step(model, opt, mesh=mesh)
    for i in range(2):
        batch = _batch(cfg, batch=4, seed=40 + i)
        params, state, m = one(params, state, batch)
        placed, placed_state, pm = sharded(placed, placed_state, batch)
        np.testing.assert_allclose(float(pm["loss"]), float(m["loss"]),
                                   rtol=1e-5)
    got, _ = gather_state(placed, placed_state)
    _check_close(got, params, atol=2e-5, bound=2 * 2 * 1e-3)
    out = train.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                      "--model-axis", "2", "--simulate-devices", "2",
                      "--steps", "2", "--seq-len", "16", "--global-batch",
                      "2"])
    assert out["final_step"] == 2


def _tiny(remat="none", impl="dense"):
    return ModelConfig(
        name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=64,
        dtype="float32", remat=remat, energon=EnergonConfig(impl=impl))


def _loop(cfg, steps, ckpt_dir=None, every=200, lr=3e-3, **kw):
    ds = TokenDataset(cfg.vocab_size, seq_len=32, global_batch=8, seed=0,
                      corpus_tokens=20000)
    tc = TrainConfig(total_steps=steps, log_every=1, checkpoint_dir=ckpt_dir,
                     checkpoint_every=every,
                     optimizer=AdamWConfig(learning_rate=lr), **kw)
    return TrainLoop(LMModel(cfg, device="cpu"), tc, ds)


def _state_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


def test_train_loop_resumes_with_equal_state(tmp_path):
    cfg = _tiny(remat="full", impl="mpmrf_row")
    whole = _loop(cfg, 4).run()
    first = _loop(cfg, 2, str(tmp_path), every=2, num_microbatches=2).run()
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [2]
    resumed = _loop(cfg, 4, str(tmp_path), num_microbatches=2)
    params, opt, start = resumed._init_state()
    assert start == 2 and resumed.dataset.state == {"step": 2}
    assert _state_equal((params, opt), (first["params"],
                                        first["opt_state"]))
    out = resumed.run()
    assert out["final_step"] == 4
    assert [h["step"] for h in out["history"]] == [3, 4]
    # two microbatches of 4 and one batch of 8 agree to rounding
    for h, w in zip(out["history"], whole["history"][2:]):
        np.testing.assert_allclose(h["loss"], w["loss"], rtol=1e-5)
    again = _loop(cfg, 4, str(tmp_path / "b"), every=2,
                  num_microbatches=2).run()
    assert [h["loss"] for h in out["history"]] == [
        h["loss"] for h in again["history"][2:]]
    assert _state_equal(out["params"], again["params"])


def test_train_loop_stops_on_preemption_and_saves(tmp_path):
    loop = _loop(_tiny(), 10, str(tmp_path))
    real = loop.step_fn
    count = [0]

    def step(*a):
        count[0] += 1
        if count[0] == 3:
            loop.preemption.request_stop()
        return real(*a)

    loop.step_fn = step
    out = loop.run()
    assert out["final_step"] == 3
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [3]
    assert loop.dataset.state == {"step": 3}


def test_a_tiny_model_learns_and_serves():
    loop = _loop(_tiny(), 60)
    out = loop.run()
    hist = out["history"]
    assert len(hist) == 60
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.25, hist
    for p in jax.tree.leaves(out["params"]):
        assert not p.requires_grad
    engine = ServeLoop(loop.model, out["params"], batch_slots=2, max_len=64,
                       eos_token=-1, prefill_chunk=16, device="cpu")
    corpus = loop.dataset.corpus
    for uid in range(3):
        engine.submit(Request(uid=uid, prompt=[int(x) for x in
                                               corpus[uid * 40:uid * 40 + 20]],
                              max_new_tokens=6))
    done = engine.run_until_drained()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(len(r.tokens_out) == 6 for r in done)


def test_the_train_launchers_run_on_the_cpu(capsys, tmp_path):
    from repro_torch import train_lm
    from repro_torch.launch import train

    result = train.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                         "--steps", "10", "--seq-len", "32",
                         "--global-batch", "4", "--microbatches", "2",
                         "--grad-compression", "--checkpoint-dir",
                         str(tmp_path)])
    assert result["final_step"] == 10
    assert result["opt_state"].compression_error is not None
    assert "[train] qwen3-14b on cpu: 10 steps" in capsys.readouterr().out
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [10]
    out = train_lm.run(small=True, steps=3, device="cpu",
                       corpus_tokens=3000)
    assert out["final_step"] == 3 and out["n_params"] > 0
    big = train_lm.config(small=False)
    assert (big.num_layers, big.d_model, big.num_heads, big.d_ff,
            big.vocab_size, big.remat, big.energon.impl,
            big.energon.min_prune_layer) == (12, 768, 12, 3072, 32768,
                                             "dots", "mpmrf_row", 2)

"""The port's optimizer (``repro_torch.optim``) against the reference's
``repro.optim``, on the CPU, from the same numpy state and gradients.

* ``update`` over 5 steps from one f32 state, for each configuration:
  plain (no clip), clipped (the clip engaged every step), the factored
  second moment, bf16 momentum, ``chunked_update`` (a stacked leaf of 8
  slices), a warmup-cosine learning rate, and the carried
  gradient-compression state; the tree holds a matrix, a stacked 3-d
  leaf, a 1-d and a 0-d leaf (the last two without decay). Params,
  moments, step and metrics are compared after every step; the port's
  update leaves the gradients as they were.
* ``warmup_cosine``'s values at every step of a schedule.
* ``accumulate_gradients`` at 1 and 4 microbatches on a smoke model's
  loss: the two agree with each other and with the reference's.

Tolerances: f32 values at rtol 1e-5, atol 1e-6 (both sides compute the
same f32 arithmetic; the frameworks may contract a product and a sum
into one fused multiply-add, or take a reduction in another order);
a bf16 moment within one bf16 ulp (rtol 2^-8) where an f32 difference
falls on a rounding boundary; the schedule at rtol 1e-6 (one f32 ulp of
``cos``); gradients at rtol 1e-4, atol 1e-6, as the model tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LMModel as JaxLMModel
from repro.optim import adamw as jadamw
from repro_torch.configs import registry
from repro_torch.convert import (
    convert_opt_state, convert_params, to_numpy_tree,
)
from repro_torch.models import LMModel
from repro_torch.optim import adamw
from tests._torch_port import jax_model_config, t

TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2 ** -8, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEPS = 5


def _params(rng):
    return {
        "w": rng.normal(size=(8, 6)).astype(np.float32),
        "stack": {"w": rng.normal(size=(8, 4, 5)).astype(np.float32)},
        "bias": rng.normal(size=(6,)).astype(np.float32),
        "gain": np.float32(rng.normal()),
    }


def _grads(rng, like, scale):
    return jax.tree.map(
        lambda p: (scale * rng.normal(size=np.shape(p))).astype(np.float32),
        like)


CASES = {
    "plain": dict(clip_norm=0.0),
    "clipped": dict(clip_norm=0.5),
    "factored": dict(factored_second_moment=True),
    "bf16_momentum": dict(momentum_dtype="bfloat16"),
    "chunked": dict(chunked_update=True),
    "schedule": dict(learning_rate="schedule"),
    "compression": dict(grad_compression=True),
}


def _configs(case):
    kw = dict(CASES[case], weight_decay=0.1)
    kw.setdefault("learning_rate", 1e-2)
    if kw["learning_rate"] == "schedule":
        return (adamw.AdamWConfig(**dict(
                    kw, learning_rate=adamw.warmup_cosine(1e-2, 2, 5))),
                jadamw.AdamWConfig(**dict(
                    kw, learning_rate=jadamw.warmup_cosine(1e-2, 2, 5))))
    return adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)


def _torch(tree):
    return jax.tree.map(lambda a: t(a), tree)


def _check_tree(port, ref, tol):
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    port_leaves = jax.tree_util.tree_leaves_with_path(to_numpy_tree(port))
    assert [p for p, _ in port_leaves] == [p for p, _ in ref_leaves]
    for (path, a), (_, b) in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(b, np.float32),
            err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("case", CASES)
def test_update_matches_the_reference_over_five_steps(case):
    rng = np.random.default_rng(3)
    np_params = _params(rng)
    cfg, jcfg = _configs(case)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = jadamw.init(jparams, jcfg)
    params = _torch(np_params)
    state = convert_opt_state(jax.tree.map(np.asarray, jstate), params)
    jupdate = jax.jit(lambda g, s, p: jadamw.update(g, s, p, jcfg))
    mu_tol = BF16_TOL if case == "bf16_momentum" else TOL
    for _ in range(STEPS):
        # a large scale engages the clip (norm ≫ 0.5) every step
        np_grads = _grads(rng, np_params, 3.0)
        grads = _torch(np_grads)
        kept = jax.tree.map(torch.clone, grads)
        jparams, jstate, jm = jupdate(
            jax.tree.map(jnp.asarray, np_grads), jstate, jparams)
        params, state, m = adamw.update(grads, state, params, cfg)
        jax.tree.map(lambda a, b: torch.testing.assert_close(
            a, b, rtol=0, atol=0), grads, kept)
        _check_tree(params, jparams, TOL)
        _check_tree(state.mu, jstate.mu, mu_tol)
        _check_tree(state.nu, jstate.nu, TOL)
        assert int(state.step) == int(jstate.step)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    if case == "clipped":
        assert float(m["grad_norm"]) > 0.5
    if case == "factored":
        assert set(state.nu["w"]) == {"row", "col"}
        assert state.nu["w"]["row"].shape == (8,)
        assert state.nu["stack"]["w"]["col"].shape == (8, 5)
    if case == "bf16_momentum":
        assert state.mu["w"].dtype == torch.bfloat16
    if case == "compression":
        _check_tree(state.compression_error, jstate.compression_error,
                    dict(rtol=0, atol=0))
        assert float(state.compression_error["w"].abs().max()) == 0.0
    else:
        assert state.compression_error is None


def test_vectors_and_scalars_are_not_decayed():
    """With zero gradients, only the matrices move (decay), and by
    exactly lr·wd·p."""
    rng = np.random.default_rng(0)
    params = _torch(_params(rng))
    before = jax.tree.map(torch.clone, params)
    cfg = adamw.AdamWConfig(learning_rate=0.5, weight_decay=0.1,
                            clip_norm=0.0)
    state = adamw.init(params, cfg)
    zeros = jax.tree.map(torch.zeros_like, params)
    adamw.update(zeros, state, params, cfg)
    assert torch.equal(params["bias"], before["bias"])
    assert torch.equal(params["gain"], before["gain"])
    torch.testing.assert_close(params["w"], before["w"] * (1 - 0.05))
    torch.testing.assert_close(params["stack"]["w"],
                               before["stack"]["w"] * (1 - 0.05))


def test_warmup_cosine_matches_the_reference():
    for args in ((3e-4, 6, 60), (1e-2, 0, 10), (2e-3, 10, 10)):
        port, ref = adamw.warmup_cosine(*args), jadamw.warmup_cosine(*args)
        for step in range(args[2] + 3):
            np.testing.assert_allclose(
                float(port(torch.tensor(step, dtype=torch.int32))),
                float(ref(jnp.asarray(step, jnp.int32))), rtol=1e-6,
                err_msg=f"{args} at step {step}")


@pytest.fixture(scope="module")
def smoke_pair():
    cfg = registry.get_smoke_config("qwen3-14b")
    cfg = dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, pruning_ratio=1.0))
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    rng = np.random.default_rng(5)
    toks, tgts = (rng.integers(1, 255, size=(8, 32)).astype(np.int32)
                  for _ in range(2))
    return jmodel, jparams, model, params, toks, tgts


@pytest.mark.parametrize("micro", [1, 4])
def test_accumulate_gradients_matches_full_batch_and_reference(smoke_pair,
                                                                micro):
    jmodel, jparams, model, params, toks, tgts = smoke_pair
    batch = {"inputs": t(toks), "targets": t(tgts)}
    full_loss, full, _ = adamw.accumulate_gradients(
        model.loss, params, batch, 1)
    loss, grads, metrics = adamw.accumulate_gradients(
        model.loss, params, batch, micro)
    jloss, jgrads, _ = jax.jit(
        lambda p, b: jadamw.accumulate_gradients(jmodel.loss, p, b, micro)
    )(jparams, {"inputs": jnp.asarray(toks), "targets": jnp.asarray(tgts)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(full_loss), rtol=1e-5)
    _check_tree(grads, jgrads, GRAD_TOL)
    _check_tree(grads, to_numpy_tree(full), GRAD_TOL)
    assert float(metrics["tokens"]) == 8 * 32 / micro
    # the caller's params never require grad nor gather .grad
    for p in jax.tree.leaves(params):
        assert not p.requires_grad and p.grad is None

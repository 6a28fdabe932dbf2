"""Gradients on the port against the reference, on the CPU: the
differentiable ``LMModel.loss`` of every architecture, remat, the MoE
layer's backward and the attention routes under autograd.

* For every architecture in the registry (its ``smoke()`` config in
  f32), ``loss`` and the gradient of every parameter leaf against
  ``jax.value_and_grad(model.loss)`` from the same converted weights.
  ``mpmrf_row`` runs at ρ = 1: a q/k code on a rounding boundary flips
  a selected row (ROADMAP §C, "Parity traps").
* ``remat`` ``none`` / ``dots`` / ``full`` give the same gradients bit
  for bit (the transformer stack, and the recurrent families' block
  checkpoints); the checkpoint is taken only under grad.
* The MoE layer (its dispatch ``index_put_`` into a fresh buffer, the
  combine, the aux loss) differentiates as ``_apply_moe_reference``.
* Under grad the direct ``pallas`` route raises, and the chunked
  ``pallas`` route takes the torch scan (neither B9/B10 nor B11 is
  entered) with the reference's chunked gradients; without grad the
  kernel route still runs.

Tolerances: the loss at rtol 1e-5; gradients at rtol 1e-4 with atol
1e-6 × the leaf's largest |gradient| (the same fp32 graph in other
summation orders, as the model tests); zamba2's at rtol 1e-3 with atol
1e-4 × the leaf's largest (the f32 log-sigmoid differs from XLA's in
the last bits, ROADMAP §C, and the Mamba2 scan carries it through every
step, so a gradient near 0 keeps the difference)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LMModel as JaxLMModel
from repro.models import moe as jmoe
from repro_torch.configs import registry
from repro_torch.convert import convert_params, to_numpy_tree
from repro_torch.models import LMModel
from repro_torch.models import moe
from repro_torch.optim import adamw
from tests._torch_port import jax_model_config, t
from tests.test_torch_moe import _layer_case

GRAD_TOL = (1e-4, 1e-6)      # rtol; atol as a share of the leaf's max
LOG_SIGMOID_TOL = (1e-3, 1e-4)   # zamba2: the f32 log-sigmoid (§C)


def _rho1(cfg):
    return dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, pruning_ratio=1.0))


def _pair(cfg, seed=0):
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return jmodel, jparams, model, params


def _batch(cfg, batch=2, seq=32, seed=9, embeddings=False):
    rng = np.random.default_rng(seed)
    hi = min(cfg.vocab_size, 255)
    np_batch = {k: rng.integers(1, hi, size=(batch, seq)).astype(np.int32)
                for k in ("inputs", "targets")}
    if embeddings:
        np_batch["embeddings"] = rng.normal(
            size=(batch, seq, cfg.d_model)).astype(np.float32)
    return np_batch


def _grads(model, params, batch):
    loss, grads, _ = adamw.accumulate_gradients(
        model.loss, params, {k: t(v) for k, v in batch.items()}, 1)
    return loss, grads


def _check_grads(grads, ref, tol=GRAD_TOL):
    rtol, atol = tol
    port = jax.tree_util.tree_leaves_with_path(to_numpy_tree(grads))
    ref = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, ref))
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(port, ref):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=atol * max(np.abs(b).max(), 1e-30),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_loss_and_grads_match_the_reference(arch):
    cfg = _rho1(dataclasses.replace(registry.get_smoke_config(arch),
                                    dtype="float32"))
    jmodel, jparams, model, params = _pair(cfg)
    batch = _batch(cfg, embeddings=cfg.uses_embeddings_input)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    loss, grads = _grads(model, params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _check_grads(grads, jgrads,
                 LOG_SIGMOID_TOL if cfg.family == "hybrid" else GRAD_TOL)
    if cfg.family == "moe":
        assert float(jmetrics["aux"]) > 0
    if cfg.uses_embeddings_input:     # the embeddings feed the stack
        assert float(grads["embed"]["table"].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ["qwen3-14b", "olmoe-1b-7b", "zamba2-7b",
                                  "xlstm-1.3b"])
def test_remat_policies_give_equal_grads(arch):
    base = _rho1(registry.get_smoke_config(arch))
    model = LMModel(base, device="cpu")
    params = model.init(seed=1)
    batch = _batch(base, seed=2)
    out = {}
    for remat in ("none", "dots", "full"):
        m = LMModel(dataclasses.replace(base, remat=remat), device="cpu")
        out[remat] = _grads(m, params, batch)
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        jax.tree.map(lambda a, b: torch.testing.assert_close(
            a, b, rtol=0, atol=0), out[remat][1], out["none"][1])


def test_remat_checkpoints_under_grad_only(monkeypatch):
    from torch.utils import checkpoint as ckpt

    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    cfg = dataclasses.replace(registry.get_smoke_config("qwen3-14b"),
                              remat="dots")
    model = LMModel(cfg, device="cpu")
    params = model.init()
    batch = {k: t(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        model.loss(params, batch)
    assert not calls
    _grads(model, params, _batch(cfg))
    assert len(calls) == cfg.num_layers
    assert all(kw["use_reentrant"] is False and "context_fn" in kw
               for kw in calls)
    from repro_torch.models import transformer as tfm

    # the products without batch dims are kept, batched ones recomputed
    assert tfm._save_dots(None, torch.ops.aten.mm.default) == \
        ckpt.CheckpointPolicy.MUST_SAVE
    assert tfm._save_dots(None, torch.ops.aten.bmm.default) == \
        ckpt.CheckpointPolicy.PREFER_RECOMPUTE
    with pytest.raises(ValueError, match="unknown remat"):
        LMModel(dataclasses.replace(cfg, remat="some"),
                device="cpu").loss(params, batch)


@pytest.mark.parametrize("factor", [0.25, 8.0], ids=["drops", "keeps"])
def test_moe_layer_grads_match_the_reference(factor):
    cfg, jcfg, np_params, x = _layer_case("olmoe-1b-7b", factor)
    cot = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        out, m = jmoe._apply_moe_reference(p, x, jcfg)
        return jnp.sum(out * cot) + m["moe_aux_loss"]

    jg = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x))
    params = {k: t(v).requires_grad_() for k, v in np_params.items()}
    xt = t(x).requires_grad_()
    out, m = moe.apply_moe(params, xt, cfg)
    loss = (out * t(cot)).sum() + m["moe_aux_loss"]
    grads = torch.autograd.grad(loss, [params[k] for k in np_params] + [xt])
    _check_grads(dict(zip(list(np_params) + ["x"], grads)),
                 dict(jg[0], x=jg[1]))


def _pallas(n_threshold=None):
    cfg = registry.get_serve_config("qwen3-14b", smoke=True)
    if n_threshold is not None:
        cfg = dataclasses.replace(cfg, energon=dataclasses.replace(
            cfg.energon, chunk_threshold=n_threshold))
    return cfg


def test_the_direct_pallas_route_raises_under_grad():
    cfg = _pallas()
    model = LMModel(cfg, device="cpu")
    params = model.init()
    batch = _batch(cfg, seq=64)
    with torch.no_grad():            # scoring still runs the kernels
        loss, _ = model.loss(params, {k: t(v) for k, v in batch.items()})
    assert torch.isfinite(loss)
    with pytest.raises(NotImplementedError,
                       match="mpmrf_block.*energon_block_attention"):
        _grads(model, params, batch)


def test_the_chunked_pallas_route_takes_the_scan_under_grad(monkeypatch):
    """Past chunk_threshold a configured pallas call runs B9 → B10 on the
    sparse layers and B11 on the dense prefix; under grad it takes the
    scan, as the reference does, with the reference's gradients."""
    from repro_torch.kernels import ops as kops

    seq = 256                             # B11 takes multiples of 128
    cfg = _pallas(n_threshold=seq * seq - 1)
    calls = []
    for name in ("chunked_block_attention", "flash_attention"):
        real = getattr(kops, name)
        monkeypatch.setattr(kops, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    jmodel, jparams, model, params = _pair(cfg)
    batch = _batch(cfg, seq=seq)
    with torch.no_grad():
        model.loss(params, {k: t(v) for k, v in batch.items()})
    assert sorted(set(calls)) == ["chunked_block_attention",
                                  "flash_attention"]
    calls.clear()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    loss, grads = _grads(model, params, batch)
    assert not calls
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _check_grads(grads, jgrads)



"""The vlm and audio families — llava-next-34b (G = 7) and musicgen-medium
(LayerNorm, GELU, MHA) — and their frontend stubs, in the port against
the reference, on the CPU.

Both run the dense stack; what is theirs is the ``embeddings`` input of
``apply`` / ``loss``, ``prefill`` and ``decode_step``: precomputed patch
or frame embeddings cast to the model dtype *without* the token path's
√d_model scale. The stubs draw from a seeded ``torch.Generator``, so
their numbers differ from ``jax.random``'s; the parity tests pass the
reference stub's array across as numpy.

With the reference's weights carried across by ``repro_torch.convert``:
``apply`` logits and ``loss`` over embeddings and over tokens, paged and
contiguous ``prefill`` / ``decode_step`` logits over embeddings, and
greedy ``ServeLoop`` streams (which feed tokens, as the reference's do)
equal to the JAX engine's. The smoke configs run ``mpmrf_row`` at ρ = 1
(ROADMAP §C), the serve-smoke configs the fused path's ``pallas``.

Tolerances: logits at atol = rtol = 1e-4, the loss at rtol 1e-5 (the
same fp32 graph in other summation orders); streams exactly."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LMModel as JaxLMModel
from repro.models import multimodal as jmm
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch.configs import registry
from repro_torch.convert import convert_params
from repro_torch.models import LMModel
from repro_torch.models import multimodal as mm
from repro_torch.runtime import Request, ServeLoop
from tests._torch_port import jax_model_config, n, t

ARCHS = {"llava-next-34b": "llava_next_34b",
         "musicgen-medium": "musicgen_medium"}
TOL = dict(atol=1e-4, rtol=1e-4)
SEQ, MAX_LEN, CHUNK, EOS = 48, 64, 16, -1


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    port = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    ref = importlib.import_module(f"repro.configs.{ARCHS[arch]}")
    assert arch in registry.ARCH_NAMES
    assert jax_model_config(port.CONFIG) == ref.CONFIG
    assert jax_model_config(port.smoke()) == ref.smoke()
    assert registry.get_config(arch) is port.CONFIG
    assert registry.get_serve_config(arch).energon.impl == "pallas"
    model = LMModel(port.CONFIG, device="meta")
    assert model.supports_prefill and model.supports_paged
    assert port.CONFIG.uses_embeddings_input
    ref_shapes = jax.eval_shape(JaxLMModel(ref.CONFIG).init,
                                jax.random.PRNGKey(0))
    assert model.param_shapes() == jax.tree.map(
        lambda a: tuple(a.shape), ref_shapes)


@pytest.mark.parametrize("kind", ["vision", "audio"])
def test_the_stubs(kind):
    """Shape and dtype, the 0.02 scale of a standard normal, the seed's
    determinism on an explicit device; an unknown frontend refused."""
    out = mm.frontend_embeddings(kind, 2, 512, 64, torch.bfloat16,
                                 device="cpu")
    assert out.shape == (2, 512, 64) and out.dtype == torch.bfloat16
    assert out.device.type == "cpu"
    assert abs(float(out.float().std()) - 0.02) < 1e-3
    ref = jmm.frontend_embeddings(kind, 2, 512, 64)
    assert ref.shape == out.shape
    fn = (mm.vision_patch_embeddings if kind == "vision"
          else mm.audio_frame_embeddings)
    a = fn(1, 8, 16, device="cpu")
    assert torch.equal(a, fn(1, 8, 16, device="cpu"))
    assert not torch.equal(a, fn(1, 8, 16, seed=5, device="cpu"))
    assert torch.equal(mm.frontend_embeddings(kind, 1, 8, 16,
                                              device="cpu"), a)
    with pytest.raises(ValueError, match="unknown frontend"):
        mm.frontend_embeddings("text", 1, 8, 16, device="cpu")


def _rho1(cfg):
    return dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, pruning_ratio=1.0))


@pytest.fixture(scope="module", params=[
    f"{a}-{v}" for a in ARCHS for v in ("smoke", "serve")])
def pair(request):
    arch, variant = request.param.rsplit("-", 1)
    cfg = (_rho1(registry.get_smoke_config(arch)) if variant == "smoke"
           else registry.get_serve_config(arch, smoke=True))
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return cfg, jmodel, jparams, model, params


def _stub(cfg, batch, seq):
    """The reference stub's embeddings, as numpy."""
    return np.asarray(jmm.frontend_embeddings(
        cfg.frontend, batch, seq, cfg.d_model), np.float32)


def test_apply_and_loss_over_embeddings_match_the_reference(pair):
    cfg, jmodel, jparams, model, params = pair
    rng = np.random.default_rng(9)
    tgts = rng.integers(1, cfg.vocab_size - 1, size=(2, SEQ)).astype(
        np.int32)
    emb = _stub(cfg, 2, SEQ)
    jbatch = {"embeddings": jnp.asarray(emb), "targets": jnp.asarray(tgts)}
    batch = {"embeddings": t(emb), "targets": t(tgts)}
    ref_logits, _ = jax.jit(jmodel.apply)(jparams, jbatch)
    logits, _ = model.apply(params, batch)
    np.testing.assert_allclose(n(logits), n(ref_logits), **TOL)
    ref_loss, _ = jax.jit(jmodel.loss)(jparams, jbatch)
    loss, _ = model.loss(params, batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    # tokens where no embeddings are given, as the reference
    toks = {"inputs": tgts, "targets": tgts}
    ref_logits, _ = jax.jit(jmodel.apply)(
        jparams, {k: jnp.asarray(v) for k, v in toks.items()})
    logits, _ = model.apply(params, {k: t(v) for k, v in toks.items()})
    np.testing.assert_allclose(n(logits), n(ref_logits), **TOL)


def test_the_embeddings_input_is_not_scaled(pair):
    """Embeddings equal to the scaled token embeddings give the token
    path's logits; the unscaled ones do not."""
    cfg, _, _, model, params = pair
    toks = torch.arange(1, 17, dtype=torch.int32)[None]
    table = params["embed"]["table"]
    ref, _ = model.apply(params, {"inputs": toks})
    scaled, _ = model.apply(params, {
        "embeddings": table[toks.long()] * cfg.d_model ** 0.5})
    plain, _ = model.apply(params, {"embeddings": table[toks.long()]})
    torch.testing.assert_close(scaled, ref, **TOL)
    assert not torch.allclose(plain, ref, **TOL)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_prefill_and_decode_over_embeddings_match_the_reference(pair,
                                                                paged):
    cfg, jmodel, jparams, model, params = pair
    prefill, decode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    tables = np.array([[3, 0, 5, 1], [2, 7, 4, 6]], np.int32)
    if paged:
        jcache = jmodel.init_paged_cache(8, max_len=MAX_LEN)
        cache = model.init_paged_cache(8, max_len=MAX_LEN)
    else:
        jcache, cache = jmodel.init_cache(2, MAX_LEN), model.init_cache(
            2, MAX_LEN)
    extra = {"block_table": tables} if paged else {}
    lens = [24, 19]
    emb = _stub(cfg, 2, 2 * CHUNK)
    zero = np.zeros(2, np.int32)
    for c in range(2):
        pos = np.full((2, CHUNK), MAX_LEN, np.int32)          # sentinels
        for b, k in enumerate(lens):
            m = max(0, min(CHUNK, k - c * CHUNK))
            pos[b, :m] = c * CHUNK + np.arange(m)
        inputs = {"embeddings": emb[:, c * CHUNK:(c + 1) * CHUNK],
                  "positions": pos, **extra}
        ref, jcache = prefill(jparams, jcache, {
            k: jnp.asarray(v) for k, v in inputs.items()}, jnp.asarray(zero))
        out, cache = model.prefill(params, cache, {
            k: t(v) for k, v in inputs.items()}, t(zero))
        real = pos < MAX_LEN
        np.testing.assert_allclose(n(out)[real], n(ref)[real], **TOL)
    idx = np.array(lens, np.int32)
    step = _stub(cfg, 2, 3)
    for s in range(3):
        inputs = {"embeddings": step[:, s:s + 1], **extra}
        if paged:
            inputs["active"] = np.array([True, True])
        ref, jcache = decode(jparams, jcache, {
            k: jnp.asarray(v) for k, v in inputs.items()}, jnp.asarray(idx))
        out, cache = model.decode_step(params, cache, {
            k: t(v) for k, v in inputs.items()}, t(idx))
        np.testing.assert_allclose(n(out), n(ref), **TOL)
        idx = idx + 1


def test_greedy_streams_match_the_reference_engine(pair):
    """The engine feeds tokens, as the reference's does."""
    cfg, jmodel, jparams, model, params = pair
    rng = np.random.default_rng(11)
    prefix = [int(x) for x in rng.integers(1, cfg.vocab_size - 1, size=16)]
    trace = [dict(uid=u, prompt=prefix + [int(x) for x in rng.integers(
        1, cfg.vocab_size - 1, size=int(rng.integers(4, 12)))],
        max_new_tokens=4) for u in range(3)]
    kw = dict(batch_slots=2, max_len=MAX_LEN, eos_token=EOS,
              prefill_chunk=CHUNK)
    out = []
    for engine, req in ((JaxServeLoop(jmodel, jparams, **kw), JaxRequest),
                        (ServeLoop(model, params, device="cpu", **kw),
                         Request)):
        for r in trace:
            engine.submit(req(**r))
        out.append({r.uid: list(r.tokens_out)
                    for r in engine.run_until_drained()})
    assert out[1] == out[0] and all(len(s) == 4 for s in out[1].values())

"""The dense configs beside qwen3-14b — starcoder2-7b (LayerNorm with a
bias, the plain GELU MLP, G = 3 at smoke widths), gemma3-27b (GeGLU, the
tied head, 5 windowed : 1 global layer, window 16 at smoke widths) and
phi3-mini-3.8b (MHA) — in the port against the reference, on the CPU.
The model tests also run phi3-mini at its published head dim of 96 (2
MHA heads, 3 layers), which the CUDA kernels take padded to 128.

The configs equal the reference's field for field; the init trees have
the reference's leaves and shapes. LayerNorm and the GELU / GeGLU /
SwiGLU MLPs match the JAX functions on the same inputs, and SiLU
matches ``jax.nn.silu`` bit for bit on every finite bf16 input. On each
serve-smoke config (impl pallas: layers 0–1 dense, the global layers
past them on the fused kernels' plain versions, the windowed ones on
the XLA block path) with the reference's weights carried across by
``repro_torch.convert``: ``apply`` logits and ``loss``, paged ``prefill`` and ``decode_step``
logits, and greedy ``ServeLoop`` streams equal to the JAX engine's,
with every prompt past gemma3's window. Last, gemma3's windowed serve
steps under the graph dispatch guard.

Tolerances: logits at atol = rtol = 1e-4, as ``test_torch_model.py``
(both sides compute the same fp32 graph in different summation orders);
the loss at rtol 1e-5; the layers at 1e-5 in fp32 and at one bf16 ulp
(atol = rtol = 2^-7) in bf16, where the two frameworks' matmuls may
round a sum differently once; streams exactly."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LMModel as JaxLMModel
from repro.models import layers as JL
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch.configs import registry
from repro_torch.convert import convert_params
from repro_torch.kernels import ops as kops
from repro_torch.models import LMModel
from repro_torch.models import layers as L
from repro_torch.runtime import Request, ServeLoop
from tests._torch_port import jax_model_config, n, t
from tests.test_torch_graph import HostSyncGuard, _filled

ARCHS = {"starcoder2-7b": "starcoder2_7b", "gemma3-27b": "gemma3_27b",
         "phi3-mini-3.8b": "phi3_mini_3_8b"}
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2.0 ** -7, rtol=2.0 ** -7)
#: chunks of 16 rows fold to G·16 rows, whole query blocks of 16 for every
#: G, so the global sparse layers take the fused prefill (phi3's G = 1
#: too)
SEQ, MAX_LEN, CHUNK, EOS = 64, 64, 16, -1


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    port = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    ref = importlib.import_module(f"repro.configs.{ARCHS[arch]}")
    assert arch in registry.ARCH_NAMES
    assert jax_model_config(port.CONFIG) == ref.CONFIG
    assert jax_model_config(port.smoke()) == ref.smoke()
    assert registry.get_config(arch) is port.CONFIG
    serve = registry.get_serve_config(arch)
    assert serve.energon.impl == "pallas"     # phi3's head dim 96 too
    LMModel(port.CONFIG, device="meta")        # every full config builds
    LMModel(port.smoke(), device="cpu")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_the_reference(arch):
    cfg = registry.get_smoke_config(arch)
    ref = jax.eval_shape(JaxLMModel(jax_model_config(cfg)).init,
                         jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = model.init(seed=0)
    assert _shapes(params) == _shapes(ref) == model.param_shapes()
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    assert ("bias" in params["final_norm"]) == (cfg.norm == "layernorm")
    assert ("w_gate" in params["blocks"]["mlp"]) == (cfg.activation != "gelu")


def _reference_tree(cfg):
    """A zero tree of the reference init's leaves and shapes."""
    shapes = jax.eval_shape(JaxLMModel(jax_model_config(cfg)).init,
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)


def test_convert_refuses_a_tree_that_does_not_fit():
    gemma = LMModel(registry.get_smoke_config("gemma3-27b"), device="cpu")
    tree = _reference_tree(gemma.cfg)
    convert_params(tree, gemma)
    with pytest.raises(KeyError, match="has lm_head"):
        convert_params(dict(tree, lm_head={"w": np.zeros((96, 256))}), gemma)
    with pytest.raises(KeyError, match="lacks embed"):
        convert_params({k: v for k, v in tree.items() if k != "embed"},
                       gemma)
    star = LMModel(registry.get_smoke_config("starcoder2-7b"), device="cpu")
    star_tree = _reference_tree(star.cfg)
    del star_tree["final_norm"]["bias"]
    with pytest.raises(KeyError, match="lacks final_norm.bias"):
        convert_params(star_tree, star)
    star_tree = _reference_tree(star.cfg)
    star_tree["embed"]["table"] = np.zeros((255, 96))
    with pytest.raises(KeyError, match=r"embed.table is \(255, 96\)"):
        convert_params(star_tree, star)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_and_mlps_match_the_reference(dtype):
    rng = np.random.default_rng(3)
    d, f = 96, 192
    x = (rng.standard_normal((2, 5, d)) * 3 + 0.5).astype(np.float32)
    norm = {"scale": rng.standard_normal(d).astype(np.float32),
            "bias": rng.standard_normal(d).astype(np.float32)}
    mlp = {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
           for k, s in (("w_up", (d, f)), ("w_gate", (d, f)),
                        ("w_down", (f, d)))}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else BF16_TOL

    def j(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)

    def p(tree):
        return jax.tree.map(lambda a: t(a, tdt), tree)

    ref = JL.layernorm(j(norm), j(x))
    out = L.layernorm(p(norm), p(x))
    assert out.dtype == tdt
    np.testing.assert_allclose(n(out.float()), np.asarray(ref, np.float32),
                               **tol)
    for act in ("gelu", "geglu", "swiglu"):
        ref = JL.apply_mlp(j(mlp), j(x), act)
        out = L.apply_mlp(p(mlp), p(x), act)
        np.testing.assert_allclose(n(out.float()),
                                   np.asarray(ref, np.float32), **tol,
                                   err_msg=act)


#: phi3-mini's serve-smoke config at its published head dim: 2 MHA heads
#: × 96 (the kernels' padded head dim), 3 layers, blocks of 16
PHI3_D96 = "phi3-mini-3.8b-d96"


def _serve_smoke(name):
    if name == PHI3_D96:
        return dataclasses.replace(
            registry.get_serve_config("phi3-mini-3.8b", smoke=True),
            num_layers=3, d_model=192, num_heads=2, num_kv_heads=2,
            head_dim=96)
    return registry.get_serve_config(name, smoke=True)


def test_silu_matches_jax_on_every_finite_bf16():
    """``layers.silu`` against ``jax.nn.silu`` on all 65280 finite bf16
    inputs, bit for bit. XLA computes x · (1 / (1 + exp(−x))) op by op,
    each op in f32 rounded to bf16, and flushes subnormal operands and
    results to zero; ``F.silu`` (one rounding, subnormals kept) parts
    from it on 1866 of them, the op-by-op chain without the flush on
    511."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    x = jnp.asarray(bits).view(jnp.bfloat16)
    x = x[np.isfinite(np.asarray(x, np.float32))]
    assert x.shape == (65280,)
    ref = np.asarray(jax.nn.silu(x)).view(np.uint16)
    tx = torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(
        torch.bfloat16)
    out = L.silu(tx).view(torch.int16).numpy().view(np.uint16)
    assert int((out != ref).sum()) == 0


@pytest.fixture(scope="module", params=list(ARCHS) + [PHI3_D96])
def pair(request):
    """The arch's serve-smoke config in both packages, the reference's
    weights carried across."""
    cfg = _serve_smoke(request.param)
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return cfg, jmodel, jparams, model, params


def test_apply_and_loss_match_the_reference(pair):
    cfg, jmodel, jparams, model, params = pair
    assert SEQ > cfg.sliding_window                 # past gemma3's window
    rng = np.random.default_rng(9)
    toks, tgts = (rng.integers(1, cfg.vocab_size - 1, size=(2, SEQ)).astype(
        np.int32) for _ in range(2))
    jbatch = {"inputs": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    batch = {"inputs": t(toks), "targets": t(tgts)}
    ref_logits, _ = jax.jit(jmodel.apply)(jparams, jbatch)
    logits, _ = model.apply(params, batch)
    np.testing.assert_allclose(n(logits), n(ref_logits), **TOL)
    ref_loss, _ = jax.jit(jmodel.loss)(jparams, jbatch)
    loss, metrics = model.loss(params, batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert float(metrics["tokens"]) == 2 * SEQ


def test_paged_prefill_and_decode_match_the_reference(pair, monkeypatch):
    """Layers past the dense prefix without a window (all of them but
    gemma3's windowed ones) take the fused kernels' plain versions; the
    reference's windowed models take its XLA paths on the global layers
    too (their survivor tables are the same, and fp32 leaves P as is)."""
    cfg, jmodel, jparams, model, params = pair
    calls = {"prefill": 0, "decode": 0}
    for kind in calls:
        name = f"fused_paged_{kind}_attention"
        real = getattr(kops, name)

        def counted(*a, _real=real, _kind=kind, **kw):
            calls[_kind] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(kops, name, counted)
    windows = model.layer_windows() or [0] * cfg.num_layers
    fused = sum(w == 0 for w in windows[cfg.energon.min_prune_layer:])
    chunk, num_pages = CHUNK, 8
    prefill, decode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    tables = np.array([[3, 0, 5, 1], [2, 7, 4, 6]], np.int32)
    jcache = jmodel.init_paged_cache(num_pages, max_len=MAX_LEN)
    cache = model.init_paged_cache(num_pages, max_len=MAX_LEN)
    assert set(cache) == set(jcache)
    rng = np.random.default_rng(0)
    lens = [24, 19]                                 # past gemma3's window
    prompts = [rng.integers(1, cfg.vocab_size - 1, size=k) for k in lens]
    zero = np.zeros(2, np.int32)
    for c in range(2):
        toks = np.zeros((2, chunk), np.int32)
        pos = np.full((2, chunk), MAX_LEN, np.int32)    # sentinels
        for b, p in enumerate(prompts):
            part = p[c * chunk:(c + 1) * chunk]
            toks[b, :len(part)] = part
            pos[b, :len(part)] = c * chunk + np.arange(len(part))
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
    np.testing.assert_allclose(n(cache["v"]), n(jcache["v"]), atol=1e-5,
                               rtol=1e-5)
    assert calls == {"prefill": 2 * fused, "decode": 3 * fused} and fused


def _drain(engine, trace, request_cls):
    for r in trace:
        engine.submit(request_cls(**r))
    return {r.uid: list(r.tokens_out) for r in engine.run_until_drained()}


def test_greedy_streams_match_the_reference_engine(pair):
    cfg, jmodel, jparams, model, params = pair
    rng = np.random.default_rng(11)
    prefix = [int(x) for x in rng.integers(1, cfg.vocab_size - 1, size=16)]
    trace = [dict(uid=u, prompt=prefix + [int(x) for x in rng.integers(
        1, cfg.vocab_size - 1, size=int(rng.integers(4, 12)))],
        max_new_tokens=4) for u in range(3)]
    kw = dict(batch_slots=2, max_len=MAX_LEN, eos_token=EOS,
              prefill_chunk=CHUNK)
    ref = _drain(JaxServeLoop(jmodel, jparams, **kw), trace, JaxRequest)
    out = _drain(ServeLoop(model, params, device="cpu", **kw), trace,
                 Request)
    assert out == ref and all(len(s) == 4 for s in out.values())


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
@pytest.mark.parametrize("method", ["decode_step", "prefill"])
def test_windowed_serve_steps_make_no_host_sync(paged, method):
    """gemma3's serve steps, windowed layers on the XLA paths beside the
    global layer's fused kernels, under the graph dispatch guard."""
    model = LMModel(registry.get_serve_config("gemma3-27b", smoke=True),
                    device="cpu")
    assert 0 in model.layer_windows() and 16 in model.layer_windows()
    params = model.init(seed=0)
    cache, pre, zero, dec, index = _filled(model, params, paged)
    inputs, idx = (dec, index) if method == "decode_step" else (pre, zero)
    with HostSyncGuard() as guard:
        logits, _ = getattr(model, method)(params, cache, inputs, idx)
    assert guard.seen == []
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_operands_are_contiguous_at_one_sequence(monkeypatch, arch):
    """One slot (paged and contiguous) and one scored sequence: the heads
    of a single sequence reshape to strided views (and at G = 1, phi3's,
    so do the folded prefill rows), and the CUDA kernels refuse operands
    that are not contiguous. Every kernel operand of the serve-smoke
    model is a contiguous tensor here, where the plain versions would
    take either."""
    from repro_torch.kernels import block_sparse_attention as bsa
    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_filter as fk
    from repro_torch.kernels import mpmrf_prefill as pk

    strided, called = [], set()
    for mod, names in (
            (dk, ("paged_filter_scores", "paged_decode_gather_attention",
                  "mpmrf_decode_filter_scores", "decode_gather_attention")),
            (pk, ("paged_prefill_filter_scores",
                  "paged_prefill_gather_attention",
                  "mpmrf_prefill_filter_scores", "prefill_gather_attention")),
            (fk, ("mpmrf_filter_scores",)),
            (bsa, ("block_sparse_attention",))):
        for name in names:
            def checked(*a, _real=getattr(mod, name), _name=name, **kw):
                called.add(_name)
                strided.extend(
                    (_name, i) for i, x in enumerate(a)
                    if isinstance(x, torch.Tensor) and not x.is_contiguous())
                return _real(*a, **kw)

            monkeypatch.setattr(mod, name, checked)
    model = LMModel(registry.get_serve_config(arch, smoke=True),
                    device="cpu")
    params = model.init(seed=0)
    for paged in (True, False):
        engine = ServeLoop(model, params, batch_slots=1, max_len=MAX_LEN,
                           prefill_chunk=CHUNK, eos_token=EOS, paged=paged,
                           device="cpu")
        engine.submit(Request(uid=0, prompt=list(range(1, 40)),
                              max_new_tokens=3))
        engine.run_until_drained()
    toks = torch.randint(1, 200, (1, SEQ), generator=torch.Generator()
                         .manual_seed(0))
    model.loss(params, {"inputs": toks, "targets": toks})
    assert len(called) == 10 and strided == []

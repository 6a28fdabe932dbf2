"""Serving with the reference's default ``impl="mpmrf_block"`` (and
``mpmrf_row``, and ``pallas`` below the resident planes' threshold): the
port's model and ``ServeLoop`` on the XLA selection paths, on the CPU.

Mirrors the reference's ``tests/test_serving_engine.py`` contracts on
the same model shape (3 layers, d_model 32, head_dim 8, G = 2), with the
reference's weights carried over by ``repro_torch.convert``: chunked
prefill then decode reproduce ``apply``'s logits (dense, and
``mpmrf_block`` at ρ = 1, which keeps every block), ragged chunks and
sentinel slots are inert, sentinel rows do not leak into the pooled
block selection, block decode at ρ = 1 equals row decode and dense.
Then ``ServeLoop`` greedy streams equal the JAX engine's, paged and
unpaged, with an EOS no model emits (-1), on the serve-smoke model.

Tolerances: as the reference's tests state them (its ρ = 1 case at
1e-2, dense at 1e-4, inert rows at 1e-5); the port against the JAX
model at 1e-4 on logits; streams exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LMModel as JaxLMModel
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_serve_config
from repro_torch.convert import convert_params
from repro_torch.core import EnergonConfig, energon_attention
from repro_torch.core import energon_decode_attention
from repro_torch.models import LMModel
from repro_torch.runtime import Request, ServeLoop
from tests._torch_port import jax_energon, jax_model_config, n, t

EOS = -1


def _model(energon, **kw):
    """The reference test's model, built in both packages with the same
    weights."""
    cfg = ModelConfig(
        name="serve-test", family="dense", num_layers=3, d_model=32,
        num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
        dtype="float32", remat="none", energon=energon, **kw,
    )
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return cfg, model, params, jmodel, jparams


def _chunked_prefill(model, params, prompt, chunk, max_len):
    length = len(prompt)
    cache = model.init_cache(1, max_len)
    ci = torch.zeros((1,), dtype=torch.int32)
    outs = []
    for lo in range(0, length, chunk):
        part = prompt[lo:lo + chunk]
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :len(part)] = part
        pos = np.full((1, chunk), max_len, np.int32)  # sentinel = no write
        pos[0, :len(part)] = lo + np.arange(len(part))
        logits, cache = model.prefill(
            params, cache, {"tokens": t(toks), "positions": t(pos)}, ci)
        outs.append(n(logits[0, :len(part)]))
        ci = ci + len(part)
    return np.concatenate(outs, axis=0), cache, ci


@pytest.mark.parametrize("energon,atol", [
    (EnergonConfig(impl="dense"), 1e-4),
    (EnergonConfig(impl="mpmrf_block", pruning_ratio=1.0, query_block=8,
                   key_block=16, decode_key_block=16, min_prune_layer=1),
     1e-2),
], ids=["dense", "mpmrf_block_rho1"])
def test_chunked_prefill_then_decode_matches_apply(energon, atol):
    cfg, model, params, jmodel, jparams = _model(energon)
    rng = np.random.default_rng(1)
    L, chunk, max_len = 32, 8, 64
    prompt = rng.integers(1, cfg.vocab_size - 1, size=L).tolist()
    toks = t(np.asarray([prompt], np.int32))
    full_logits, _ = model.apply(params, {"inputs": toks})
    ref_full, _ = jax.jit(jmodel.apply)(
        jparams, {"inputs": jnp.asarray([prompt], jnp.int32)})
    np.testing.assert_allclose(n(full_logits), n(ref_full), atol=1e-4,
                               rtol=1e-4)
    pre_logits, cache, ci = _chunked_prefill(model, params, prompt, chunk,
                                             max_len)
    np.testing.assert_allclose(pre_logits, n(full_logits[0]), atol=atol,
                               rtol=0)
    seq = list(prompt)
    for _ in range(4):
        nxt = int(full_logits[0, len(seq) - 1].argmax())
        step_logits, cache = model.decode_step(
            params, cache, {"tokens": torch.tensor([[nxt]])}, ci)
        ci = ci + 1
        seq.append(nxt)
        full_logits, _ = model.apply(params, {"inputs": torch.tensor([seq])})
        np.testing.assert_allclose(n(step_logits[0, -1]),
                                   n(full_logits[0, -1]), atol=atol, rtol=0)


@pytest.mark.parametrize("impl", ["dense", "mpmrf_block"])
def test_ragged_chunk_and_sentinel_slots_are_inert(impl):
    """Prefilling with a second, inactive slot of garbage tokens at
    sentinel positions equals the one-slot prefill, and leaves the
    inactive slot's cache rows zero."""
    energon = EnergonConfig(impl=impl, query_block=8, key_block=16,
                            decode_key_block=16, min_prune_layer=1)
    cfg, model, params, _, _ = _model(energon)
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, cfg.vocab_size - 1, size=10).tolist()
    max_len, chunk = 32, 4          # 10 = 4+4+2 → ragged final chunk
    ref, _, _ = _chunked_prefill(model, params, prompt, chunk, max_len)
    cache = model.init_cache(2, max_len)
    ci = torch.zeros((2,), dtype=torch.int32)
    outs = []
    for lo in range(0, 10, chunk):
        part = prompt[lo:lo + chunk]
        toks = np.zeros((2, chunk), np.int32)
        toks[0, :len(part)] = part
        toks[1, :] = 17
        pos = np.full((2, chunk), max_len, np.int32)
        pos[0, :len(part)] = lo + np.arange(len(part))
        logits, cache = model.prefill(
            params, cache, {"tokens": t(toks), "positions": t(pos)}, ci)
        outs.append(n(logits[0, :len(part)]))
    np.testing.assert_allclose(np.concatenate(outs), ref, atol=1e-5, rtol=0)
    assert float(cache["k"][:, 1].abs().max()) == 0.0


def test_sentinel_rows_do_not_leak_into_block_selection():
    """Garbage in a ragged chunk's sentinel rows must not change which
    blocks its real rows attend (mpmrf_block at q_positions), and the
    real rows equal the reference's."""
    rng = np.random.default_rng(7)
    B, H, n_k, d = 1, 2, 64, 16
    real, pad = 8, 8
    k, v = (rng.normal(size=(B, H, n_k, d)).astype(np.float32)
            for _ in range(2))
    q_real = rng.normal(size=(B, H, real, d)).astype(np.float32)
    pos = np.concatenate([np.arange(32, 32 + real)[None],
                          np.full((1, pad), n_k)], axis=1).astype(np.int32)
    cfg = EnergonConfig(impl="mpmrf_block", pruning_ratio=4.0,
                        query_block=16, key_block=8, min_prune_layer=0)
    from repro.core import energon_attention as j_energon_attention

    outs = []
    for filler in (0.0, 1e3):
        q = np.concatenate([q_real, np.full((B, H, pad, d), filler,
                                            np.float32)], axis=2)
        out = energon_attention(t(q), t(k), t(v), cfg, q_positions=t(pos))
        ref = jax.jit(lambda q, k, v, p: j_energon_attention(
            q, k, v, jax_energon(cfg), q_positions=p))(q, k, v, pos)
        np.testing.assert_allclose(n(out[:, :, :real]),
                                   n(ref[:, :, :real]), atol=1e-5,
                                   rtol=1e-5)
        outs.append(n(out[:, :, :real]))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6, rtol=0)


def test_block_decode_matches_row_and_dense_at_ratio_1():
    rng = np.random.default_rng(0)
    mk = lambda s: t(rng.normal(size=s).astype(np.float32))
    q, k, v = mk((2, 4, 1, 16)), mk((2, 4, 64, 16)), mk((2, 4, 64, 16))
    cl = torch.tensor([7, 55], dtype=torch.int32)
    block = energon_decode_attention(
        q, k, v, cl, EnergonConfig(impl="mpmrf_block", pruning_ratio=1.0,
                                   decode_key_block=8, min_prune_layer=0),
        layer_index=5)
    row = energon_decode_attention(
        q, k, v, cl, EnergonConfig(impl="mpmrf_row", pruning_ratio=1.0,
                                   min_prune_layer=0), layer_index=5)
    dense = energon_decode_attention(q, k, v, cl,
                                     EnergonConfig(impl="dense"),
                                     layer_index=5)
    np.testing.assert_allclose(n(block), n(row), atol=1e-2, rtol=0)
    np.testing.assert_allclose(n(block), n(dense), atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# ServeLoop on the XLA paths against the JAX engine
# --------------------------------------------------------------------------

MAX_LEN, CHUNK = 64, 8
#: impl overrides of the serve-smoke config: the reference's default
#: block impl (planes resident at any length), the row impl, and pallas
#: with planes only from 1024 rows — below it the engine runs the XLA
#: block path with fresh quantization
IMPLS = {
    "mpmrf_block": dict(impl="mpmrf_block"),
    "mpmrf_row": dict(impl="mpmrf_row"),
    "pallas_fresh": dict(impl="pallas", filter_cache_min_len=None),
}


@pytest.fixture(scope="module", params=list(IMPLS))
def served(request):
    base = get_serve_config("qwen3-14b", smoke=True)
    cfg = dataclasses.replace(base, energon=dataclasses.replace(
        base.energon, **IMPLS[request.param]))
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    rng = np.random.default_rng(11)
    prefix = [int(x) for x in rng.integers(1, cfg.vocab_size - 1, size=16)]
    trace = [dict(uid=u, prompt=prefix + [int(x) for x in rng.integers(
        1, cfg.vocab_size - 1, size=int(rng.integers(3, 20)))],
        max_new_tokens=5) for u in range(4)]
    return request.param, cfg, model, params, jmodel, jparams, trace


def _drain(engine, trace, request_cls):
    for r in trace:
        engine.submit(request_cls(**r))
    return {r.uid: list(r.tokens_out) for r in engine.run_until_drained()}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_greedy_streams_match_reference(served, paged):
    name, cfg, model, params, jmodel, jparams, trace = served
    kw = dict(batch_slots=3, max_len=MAX_LEN, eos_token=EOS,
              prefill_chunk=CHUNK, paged=paged)
    ref = _drain(JaxServeLoop(jmodel, jparams, **kw), trace, JaxRequest)
    engine = ServeLoop(model, params, device="cpu", **kw)
    assert ("k_codes" in engine.cache) == (name == "mpmrf_block")
    out = _drain(engine, trace, Request)
    assert out == ref
    assert all(len(s) == 5 for s in out.values())


def test_quickstart_matches_the_reference_example():
    """``python -m repro_torch.quickstart --device cpu`` against
    ``examples/quickstart.py``'s four results on the same inputs: the
    row-select kept share and the relative RMSE (row selections on the
    example's own data, not exact-sum data: a tie on θ may flip, so at
    1e-3 of the share / 1e-3 absolute), the ``mpmrf_block`` output and
    the kernel pipeline's at fp32 1e-5."""
    from repro.core import EnergonConfig as JaxEnergonConfig
    from repro.core import MPMRFConfig as JaxMPMRFConfig
    from repro.core import energon_attention as j_energon_attention
    from repro.core import filtering as jflt
    from repro.core import mpmrf_row_select as j_row_select
    from repro.core import sparse_attention as jspa
    from repro.kernels import ops as jops
    from repro_torch import quickstart

    lines = []
    got = quickstart.run("cpu", log=lines.append)
    assert len(lines) == 4
    q, k, v = (jnp.asarray(x) for x in quickstart.inputs())
    B, H, n_, d = q.shape
    valid = jnp.broadcast_to(jflt.causal_valid_mask(n_, n_), (B, H, n_, n_))
    res = jax.jit(lambda q, k: j_row_select(
        q, k, JaxMPMRFConfig(round_bits=(2, 4)), valid).keep_mask)(q, k)
    kept = float(res.sum() / valid.sum())
    dense = jspa.dense_attention(q, k, v, valid)
    sparse = jspa.masked_sparse_attention(q, k, v, res)
    rel = float(jnp.sqrt(jnp.mean((dense - sparse) ** 2))
                / jnp.sqrt(jnp.mean(dense ** 2)))
    np.testing.assert_allclose(got["kept"], kept, rtol=1e-3)
    np.testing.assert_allclose(got["rel_rmse"], rel, atol=1e-3)
    block = jax.jit(lambda q, k, v: j_energon_attention(
        q, k, v, JaxEnergonConfig(impl="mpmrf_block", pruning_ratio=4.0,
                                  min_prune_layer=0)))(q, k, v)
    np.testing.assert_allclose(n(got["block_out"]), n(block), atol=1e-5,
                               rtol=1e-5)
    kern = jops.energon_block_attention(
        *(x.reshape(B * H, n_, d) for x in (q, k, v)), 2, 64, 64, True)
    np.testing.assert_allclose(n(got["kernel_out"]), n(kern), atol=1e-5,
                               rtol=1e-5)

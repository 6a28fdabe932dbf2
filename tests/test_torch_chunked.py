"""The port's chunked (long-sequence) path against the reference's
``core/chunked_attention.py``, on the CPU: each function of the scan,
the auto-switch of ``energon_attention`` past ``chunk_threshold`` for
every impl and mask, the kernel route of a configured ``pallas`` call
(B9 → selection → B10 on the sparse layers, B11 on the dense prefix,
through the kernels' plain versions here) against the torch scan, and
``LMModel.loss`` past the threshold against the JAX model.

Sizes: head_dim 16 (32 for the reference's own shapes), 128–256 keys,
blocks of 16 or 32, so the budgets prune. The q/k inputs carry the
exact-sum element of ``test_torch_xla_paths.py`` (every scale 2^-13), so
the Eq. 3 sums are exact and the selections tie-proof.

Tolerances: score planes, valid planes and survivor tables exactly;
attention outputs at fp32 atol = rtol = 1e-5; the kernel route against
the scan at the same 1e-5 (both keep P at f32); logits at 1e-4."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunked_attention as jchk
from repro.models import LMModel as JaxLMModel
from repro_torch.configs.registry import get_serve_config
from repro_torch.convert import convert_params
from repro_torch.core import chunked_attention as tchk
from repro_torch.kernels import ops as tops
from repro_torch.models import LMModel
from tests._torch_port import (
    chunked_tables, jax_energon, jax_model_config, n, t,
)
from tests.test_torch_xla_paths import _normal

JE = importlib.import_module("repro.core.energon_attention")
TE = importlib.import_module("repro_torch.core.energon_attention")

B, H, N, D = 1, 2, 128, 16
TOL = dict(atol=1e-5, rtol=1e-5)


def _close(a, b):
    np.testing.assert_allclose(n(a), n(b), **TOL)


def _eq(a, b):
    np.testing.assert_array_equal(n(a), n(b))


def _masks(case):
    """Keyword masks of one case, as numpy (the JAX side) values."""
    return {
        "causal": dict(causal=True),
        "window": dict(causal=True, window=40),
        "kv_length": dict(causal=True, kv_length=np.array([90], np.int32)),
        "q_offset": dict(causal=True, q_offset=32),
        "bidirectional": dict(causal=False),
    }[case]


def _conv(kw):
    return {k: (t(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


def _qkv(seed, n_q=N, n_k=N):
    return _normal(seed, (B, H, n_q, D), (B, H, n_k, D), (B, H, n_k, D))


def _split(kw):
    arrays = {k: v for k, v in kw.items() if isinstance(v, np.ndarray)}
    return {k: v for k, v in kw.items() if k not in arrays}, arrays


@pytest.mark.parametrize("case", ["causal", "window", "kv_length",
                                  "q_offset", "bidirectional"])
def test_chunk_functions_match_reference(case):
    """Dense chunked, the block score planes, the selection and the
    gathered Attention Unit, each against the reference's."""
    kw = _masks(case)
    n_q = 96 if case == "q_offset" else N
    q, k, v = _qkv(0, n_q=n_q)
    statics, arrays = _split(kw)

    ref = jax.jit(lambda q, k, v, a: jchk.dense_attention_chunked(
        q, k, v, chunk=32, **statics, **a))(q, k, v, arrays)
    _close(tchk.dense_attention_chunked(t(q), t(k), t(v), chunk=32,
                                        **_conv(kw)), ref)

    blocks = dict(query_block=16, key_block=16)
    rs = jax.jit(lambda q, k, a: jchk.mpmrf_block_scores_chunked(
        q, k, (2, 4), **blocks, **statics, **a))(q, k, arrays)
    ts = tchk.mpmrf_block_scores_chunked(t(q), t(k), (2, 4), **blocks,
                                         **_conv(kw))
    for o, r in zip(ts, rs):
        _eq(o, r)

    for keep_all in (False, True):
        sel = dict(alphas=(0.0, 0.0), block_budget=3, keep_all=keep_all,
                   **blocks)
        ri, rv = jchk.select_blocks_from_scores(*rs, **sel)
        ti, tv = tchk.select_blocks_from_scores(*ts, **sel)
        _eq(ti, ri)
        _eq(tv, rv)

    ref = jax.jit(lambda q, k, v, i, val, a: jchk.block_gather_attention_chunked(
        q, k, v, i, val, **blocks, **statics, **a))(q, k, v, ri, rv, arrays)
    _close(tchk.block_gather_attention_chunked(
        t(q), t(k), t(v), t(ri), t(rv), **blocks, **_conv(kw)), ref)


@pytest.mark.parametrize("ratio", [1.0, 2.0, 4.0])
def test_chunked_pipeline_matches_reference_and_direct_block_impl(ratio):
    """The reference's test_full_pipeline_matches_direct_block_impl, and
    the port's scan against the reference's on the same inputs."""
    q, k, v = _qkv(1)
    kw = dict(pruning_ratio=ratio, query_block=32, key_block=32)
    ref = jax.jit(lambda q, k, v: jchk.energon_block_attention_chunked(
        q, k, v, **kw))(q, k, v)
    out = tchk.energon_block_attention_chunked(t(q), t(k), t(v), **kw)
    _close(out, ref)
    cfg = TE.EnergonConfig(impl="mpmrf_block", min_prune_layer=0, **kw)
    _close(TE.energon_attention(t(q), t(k), t(v), cfg), out)


def _cfg(impl, threshold, **kw):
    base = dict(impl=impl, pruning_ratio=2.0, query_block=16, key_block=16,
                chunk_threshold=threshold)
    base.update(kw)
    return TE.EnergonConfig(**base)


@pytest.mark.parametrize("impl", ["dense", "mpmrf_row", "mpmrf_block",
                                  "pallas"])
@pytest.mark.parametrize("case", ["causal", "window", "kv_length",
                                  "q_offset"])
def test_auto_switch_at_threshold_matches_reference(impl, case):
    """Past ``chunk_threshold`` every impl takes the chunked path (the
    reference's scan; the port's kernel route for a causal pallas call),
    and agrees with the reference's energon_attention there; below it,
    the same call takes the direct path."""
    kw = dict(_masks(case), layer_index=5)
    n_q = 96 if case == "q_offset" else N
    q, k, v = _qkv(2, n_q=n_q)
    small = _cfg(impl, 64 * 64)
    statics, arrays = _split(kw)
    jcfg = jax_energon(small)
    ref = jax.jit(lambda q, k, v, a: JE.energon_attention(
        q, k, v, jcfg, **statics, **a))(q, k, v, arrays)
    out = TE.energon_attention(t(q), t(k), t(v), small, **_conv(kw))
    _close(out, ref)
    if impl in ("dense", "mpmrf_block") and case != "q_offset":
        # the reference's test_auto_switch_at_threshold: chunked ≡ direct
        big = _cfg(impl, 10**9)
        _close(out, TE.energon_attention(t(q), t(k), t(v), big,
                                         **_conv(kw)))


def test_positions_past_the_threshold_still_raise():
    q, k, v = _qkv(3)
    pos = torch.arange(N, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="chunk_threshold"):
        TE.energon_attention(t(q), t(k), t(v), _cfg("mpmrf_block", 64 * 64),
                             q_positions=pos)


@pytest.mark.parametrize("n_k,q_offset,ratio", [
    (128, 0, 2.0), (256, 0, 4.0), (256, 128, 4.0), (128, 0, 1.0),
])
def test_kernel_route_equals_the_scan(n_k, q_offset, ratio):
    """B9 → selection → B10 (``ops.chunked_block_attention``) against the
    torch scan on the same inputs: survivor tables bit for bit (B9's
    planes are the scan's, rescaled in the same chain; ``keep_all`` at
    ρ ≤ 1), outputs within fp32 rounding."""
    n_q = n_k - q_offset
    q, k, v = _qkv(4, n_q=n_q, n_k=n_k)
    kw = dict(pruning_ratio=ratio, query_block=16, key_block=16,
              q_offset=q_offset)
    out = tchk.energon_block_attention_chunked(t(q), t(k), t(v), **kw)
    bh = B * H
    flat = lambda x: t(x).reshape(bh, -1, D)
    kout = tops.chunked_block_attention(flat(q), flat(k), flat(v), **kw)
    (kidx, kval), (idx, val) = chunked_tables(
        t(q), t(k), pruning_ratio=ratio, query_block=16, key_block=16,
        q_offset=q_offset)
    _eq(kidx, idx)
    _eq(kval, val)
    _close(kout.reshape(out.shape), out)


def test_pallas_chunked_dispatch_runs_the_kernels(monkeypatch):
    """A configured pallas call past the threshold calls B9 and B10 on
    its sparse layers and B11 on its dense prefix, with the selection
    the scan makes; other configs never do."""
    from repro_torch.kernels import block_sparse_attention as bsa
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mpmrf_filter as mf

    calls = []
    for mod, name in ((mf, "mpmrf_filter_scores"),
                      (bsa, "block_sparse_attention"),
                      (fa, "flash_attention")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    q, k, v = _qkv(5)
    cfg = _cfg("pallas", 64 * 64, min_prune_layer=2)
    sparse = TE.energon_attention(t(q), t(k), t(v), cfg, layer_index=2)
    assert calls == ["mpmrf_filter_scores", "block_sparse_attention"]
    _close(sparse, tchk.energon_block_attention_chunked(
        t(q), t(k), t(v), pruning_ratio=2.0, query_block=16,
        key_block=16))
    calls.clear()
    dense = TE.energon_attention(t(q), t(k), t(v), cfg, layer_index=0)
    assert calls == ["flash_attention"]
    _close(dense, tchk.dense_attention_chunked(t(q), t(k), t(v)))
    calls.clear()
    TE.energon_attention(t(q), t(k), t(v), cfg, layer_index=2, window=40)
    TE.energon_attention(t(q), t(k), t(v), dataclasses.replace(
        cfg, impl="mpmrf_block"), layer_index=2)
    assert calls == []


@pytest.mark.parametrize("impl", ["pallas", "mpmrf_block"])
def test_lm_loss_past_the_threshold_matches_reference(impl):
    """``LMModel.apply`` / ``loss`` on the serve-smoke model with the
    threshold below its sequence: every layer takes the chunked path
    (the kernel route for pallas, the scan for mpmrf_block) and the
    logits agree with the JAX model's."""
    base = get_serve_config("qwen3-14b", smoke=True)
    cfg = dataclasses.replace(base, energon=dataclasses.replace(
        base.energon, impl=impl, chunk_threshold=32 * 32,
        min_prune_layer=1))
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    rng = np.random.default_rng(6)
    toks = rng.integers(1, cfg.vocab_size - 1, size=(2, 64)).astype(np.int32)
    tgts = rng.integers(1, cfg.vocab_size - 1, size=(2, 64)).astype(np.int32)
    jbatch = {"inputs": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    ref_logits, _ = jax.jit(jmodel.apply)(jparams, jbatch)
    logits, _ = model.apply(params, {"inputs": t(toks)})
    np.testing.assert_allclose(n(logits), n(ref_logits), atol=1e-4,
                               rtol=1e-4)
    loss, metrics = model.loss(params, {"inputs": t(toks),
                                        "targets": t(tgts)})
    ref_ce = -np.take_along_axis(
        jax.nn.log_softmax(ref_logits, axis=-1), tgts[..., None], -1).mean()
    np.testing.assert_allclose(float(loss), float(ref_ce), rtol=1e-5)

"""The port's full-sequence sparse path against the reference's, on the
CPU: B9–B11 (their plain versions) against the Pallas kernels in
interpret mode, ``ops.mpmrf_select_blocks``, ``energon_attention``'s
full-sequence branches, ``energon_block_attention``'s gradients, and
``LMModel.apply`` / ``loss`` of the qwen3-14b serve-smoke config.

Sizes: head_dim 16, n = 64, query/key blocks of 16 and ρ = 2, so the
budget (2 of 4 key blocks) really prunes. Every JAX side that
quantizes runs under ``jax.jit``, as the reference does wherever it is
used (XLA turns its divide by 32767 into the multiply the port makes).

Tolerances: filter scores, survivor tables and valid flags exactly;
attention outputs at fp32 atol = rtol = 1e-5 (the same products summed
in another order); logits at 1e-4, as ``test_torch_model.py`` states."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energon_attention as j_energon_attention
from repro.core import filtering as jflt
from repro.kernels import mpmrf_filter as jfilt
from repro.kernels import ops as jops
from repro.models import LMModel as JaxLMModel
from repro.models import layers as jlayers
from repro_torch.configs.registry import get_serve_config
from repro_torch.convert import convert_params
from repro_torch.core import EnergonConfig, energon_attention
from repro_torch.core import filtering as tflt
from repro_torch.kernels import block_sparse_attention as tbsa
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mpmrf_filter as tfilt
from repro_torch.kernels import ops as tops
from repro_torch.models import LMModel
from repro_torch.models import layers as tlayers
from tests._torch_port import jax_energon, jax_model_config, n, t
from tests.test_torch_xla_paths import _normal

BH, N, D, BLK = 4, 64, 16, 16
TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, shape=(BH, N, D)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 16),
                                             (False, 0)])
def test_b9_filter_scores_bit_exact(causal, q_offset):
    rng = np.random.default_rng(0)
    qp = rng.integers(-8, 8, size=(BH, N, D)).astype(np.int8)
    msb = rng.integers(-2, 2, size=(BH, N, D)).astype(np.int8)
    rem = rng.integers(0, 4, size=(BH, N, D)).astype(np.int8)
    qs = rng.uniform(1e-5, 1e-3, size=(BH, N, 1)).astype(np.float32)
    kw = dict(shift=2, query_block=BLK, key_block=BLK, causal=causal,
              q_offset=q_offset)
    ref = jfilt.mpmrf_filter_scores(
        jnp.asarray(qp), jnp.asarray(msb), jnp.asarray(rem),
        jnp.asarray(qs), interpret=True, **kw)
    out = tfilt.mpmrf_filter_scores(t(qp), t(msb), t(rem), t(qs), **kw)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(n(o), n(r))
    if causal and q_offset == 0:     # tiles above the diagonal are empty
        assert (n(out[0])[:, 0, 1:] == tfilt.NEG_INF).all()


@pytest.mark.parametrize("q_offset", [0, 16])
def test_b10_block_sparse_attention_matches_pallas(q_offset):
    q, k, v = _qkv(1)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, N // BLK, size=(BH, N // BLK, 2)).astype(np.int32)
    val = (rng.uniform(size=idx.shape) < 0.8).astype(np.int32)
    val[0, 0] = 0                     # a query block with no survivor
    kw = dict(query_block=BLK, key_block=BLK, causal=True, q_offset=q_offset)
    ref = jops.block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx),
        jnp.asarray(val), interpret=True, **kw)
    out = tbsa.block_sparse_attention(t(q), t(k), t(v), t(idx), t(val), **kw)
    np.testing.assert_allclose(n(out), n(ref), **TOL)
    assert not n(out)[0, :BLK].any()


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 16),
                                             (False, 0)])
def test_b11_flash_attention_matches_pallas(causal, q_offset):
    q, k, v = _qkv(3)
    ref = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_offset, block_q=BLK, block_k=BLK, interpret=True)
    out = tfa.flash_attention(t(q), t(k), t(v), causal=causal,
                              q_offset=q_offset, block_q=BLK, block_k=BLK)
    np.testing.assert_allclose(n(out), n(ref), **TOL)
    # every key block a survivor: the sparse kernel is the dense one
    n_qb, n_kb = N // BLK, N // BLK
    all_idx = torch.arange(n_kb, dtype=torch.int32).expand(BH, n_qb, n_kb)
    full = tbsa.block_sparse_attention(
        t(q), t(k), t(v), all_idx, torch.ones_like(all_idx),
        query_block=BLK, key_block=BLK, causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(n(full), n(out), **TOL)


@pytest.mark.parametrize("p_operand,admitted", [("bf16", False),
                                                  ("bf16 hi + lo", True)])
def test_pv_product_needs_p_at_f32_accuracy(p_operand, admitted):
    """Why B10/B11 multiply P·V as two bf16 products, hi = bf16(p) and
    lo = bf16(p − hi), on the tensor cores: rows where three keys carry
    the softmax and two of their values cancel, emulated in f32 from
    bf16 V. P rounded once to bf16 leaves the gather tolerance (the
    kernels' contract with their plain versions); the split keeps P at
    f32 accuracy and stays inside it."""
    from repro_torch.kernels import gather_within_tolerance

    rng = np.random.default_rng(11)
    rows, d = 64, 16
    s = rng.normal(scale=0.5, size=(rows, 3))
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    v0 = rng.uniform(1.0, 4.0, size=(rows, d)) * rng.choice([-1, 1],
                                                            size=(rows, d))
    v1 = -(p[:, :1] / p[:, 1:2]) * v0 + rng.normal(scale=0.05,
                                                   size=(rows, d))
    v2 = rng.normal(scale=0.05, size=(rows, d))
    vf = torch.tensor(np.stack([v0, v1, v2], axis=1)).to(
        torch.bfloat16).float()                            # [rows, 3, d]
    pt = torch.tensor(p)                                   # [rows, 3] f32
    l = pt.sum(-1, keepdim=True)
    ref = (torch.einsum("rk,rkd->rd", pt, vf) / l).to(torch.bfloat16)
    hi = pt.to(torch.bfloat16).float()
    acc = torch.einsum("rk,rkd->rd", hi, vf)
    if p_operand == "bf16 hi + lo":
        lo = (pt - hi).to(torch.bfloat16).float()
        acc = acc + torch.einsum("rk,rkd->rd", lo, vf)
    out = (acc / l).to(torch.bfloat16)
    assert gather_within_tolerance(out, ref) is admitted


def _jit_select(**kw):
    return jax.jit(functools.partial(jops.mpmrf_select_blocks,
                                     interpret=True, **kw))


@pytest.mark.parametrize("case", ["random", "offset", "ties"])
def test_select_blocks_exact(case):
    q, k, _ = _qkv(4)
    kw = dict(block_budget=2, query_block=BLK, key_block=BLK, causal=True,
              q_offset=16 if case == "offset" else 0)
    if case == "ties":
        # every key block the same rows: fully visible blocks tie on both
        # rounds, and top-B must take the lower index first
        k = np.tile(k[:, :BLK], (1, N // BLK, 1))
    ref = _jit_select(**kw)(jnp.asarray(q), jnp.asarray(k))
    out = tops.mpmrf_select_blocks(t(q), t(k), **kw)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(n(o), n(r))
    if case == "ties":
        # query block 3 sees blocks 0–2 whole (equal maxima) and its
        # diagonal in part (no larger): the two lowest of the tie win
        assert n(out[0])[:, 3].tolist() == [[0, 1]] * BH


@pytest.mark.parametrize("layer_index", [0, 5])
def test_energon_attention_full_sequence(layer_index):
    """layer 0 < min_prune_layer takes the dense causal branch; layer 5
    the pallas branch (B9 + selection + B10)."""
    cfg = EnergonConfig(impl="pallas", query_block=BLK, key_block=BLK,
                        pruning_ratio=2.0)
    q, k, v = _qkv(5, (2, 2, N, D))
    ref = jax.jit(functools.partial(
        j_energon_attention, cfg=jax_energon(cfg), layer_index=layer_index,
    ))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = energon_attention(t(q), t(k), t(v), cfg, layer_index=layer_index)
    np.testing.assert_allclose(n(out), n(ref), **TOL)


def test_causal_mask_and_cross_entropy_match_reference():
    np.testing.assert_array_equal(
        n(tflt.causal_valid_mask(5, 9, 3)),
        np.asarray(jflt.causal_valid_mask(5, 9, 3)))
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(2, 7)).astype(np.int32)
    mask = (rng.uniform(size=(2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        ref = jlayers.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        out = tlayers.softmax_cross_entropy(
            t(logits), t(labels), None if m is None else t(m))
        np.testing.assert_allclose(n(out[0]), n(ref[0]), rtol=1e-6)
        assert float(out[1]) == float(ref[1])


def test_energon_block_attention_grads_match_reference():
    q, k, v = _qkv(7)
    g = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    args = (2, BLK, BLK, True)

    def jloss(q, k, v):
        return jnp.sum(jops.energon_block_attention(q, k, v, *args)
                       * jnp.asarray(g))

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    out = tops.energon_block_attention(*leaves, *args)
    grads = torch.autograd.grad(out, leaves, t(g))
    for r, o in zip(ref, grads):
        np.testing.assert_allclose(n(o), n(r), **TOL)


def _model_pair():
    cfg = get_serve_config("qwen3-14b", smoke=True)
    cfg = dataclasses.replace(
        cfg, energon=dataclasses.replace(cfg.energon, pruning_ratio=2.0))
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return cfg, jmodel, jparams, model, params


def test_lm_model_apply_and_loss_match_reference():
    cfg, jmodel, jparams, model, params = _model_pair()
    # layers 0–1 dense, layer 2 sparse through B9 + B10
    assert cfg.energon.impl == "pallas" and cfg.energon.min_prune_layer == 2
    rng = np.random.default_rng(9)
    toks = rng.integers(1, cfg.vocab_size - 1, size=(2, N)).astype(np.int32)
    tgts = rng.integers(1, cfg.vocab_size - 1, size=(2, N)).astype(np.int32)
    jbatch = {"inputs": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    batch = {"inputs": t(toks), "targets": t(tgts)}
    ref_logits, _ = jax.jit(jmodel.apply)(jparams, jbatch)
    logits, aux = model.apply(params, batch)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(n(logits), n(ref_logits), atol=1e-4,
                               rtol=1e-4)
    ref_loss, ref_metrics = jax.jit(jmodel.loss)(jparams, jbatch)
    loss, metrics = model.loss(params, batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert float(metrics["tokens"]) == float(ref_metrics["tokens"]) == 2 * N


@pytest.mark.parametrize("case", [
    "ragged", "one_key_block", "past_chunk_threshold", "window",
    "kv_length", "mpmrf_block", "mpmrf_row",
])
def test_off_path_full_sequence_calls_raise(case):
    """The full-sequence calls off the B9 + B10 kernels, which the port
    once refused, now take the reference's branch — the row fallback
    (ragged, one key block), the chunked path, the XLA block path
    (window, kv_length) and the XLA impls — and match the JAX
    ``energon_attention`` on the same inputs (the name is kept from the
    refusal test these cases replace)."""
    cfg = EnergonConfig(impl="pallas", query_block=BLK, key_block=BLK,
                        pruning_ratio=2.0)
    length, kw = N, {}
    if case == "ragged":
        length = N - 8
    elif case == "one_key_block":
        length = BLK
    elif case == "past_chunk_threshold":
        cfg = dataclasses.replace(cfg, chunk_threshold=N * N - 1)
    elif case == "window":
        kw = dict(window=32)
    elif case == "kv_length":
        kw = dict(kv_length=np.full((2,), N - 3, np.int32))
    else:
        cfg = dataclasses.replace(cfg, impl=case)
    # exact-sum inputs: the row selections' Eq. 3 sums are exact, so no
    # tie on θ flips with the summation order
    q, k, v = _normal(10, *[(2, 2, length, D)] * 3)
    jcfg = jax_energon(cfg)
    arrays = {k_: jnp.asarray(v_) for k_, v_ in kw.items()
              if isinstance(v_, np.ndarray)}
    statics = {k_: v_ for k_, v_ in kw.items() if k_ not in arrays}
    ref = jax.jit(lambda q, k, v, a: j_energon_attention(
        q, k, v, jcfg, layer_index=5, **statics, **a))(q, k, v, arrays)
    out = energon_attention(
        t(q), t(k), t(v), cfg, layer_index=5,
        **{k_: (t(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()})
    np.testing.assert_allclose(n(out), n(ref), **TOL)


def test_unknown_impl_raises():
    q, k, v = (t(x) for x in _qkv(10, (2, 2, N, D)))
    with pytest.raises(ValueError, match="unknown Energon impl"):
        energon_attention(q, k, v, EnergonConfig(impl="bogus"), layer_index=5)

"""The port's unpaged (contiguous-cache) serving path against the
reference, and its in-port contracts.

Kernels: B5 / B7 plain scores bit-equal to the reference's
``mpmrf_decode_filter_scores`` / ``mpmrf_prefill_filter_scores`` (Pallas
in interpret mode), B7 also with a key block spanning two scale groups;
B6 / B8 plain outputs at fp32 1e-5 of ``decode_gather_attention`` /
``prefill_gather_attention`` (the two sum the same products in other
orders), with sentinel rows, lengths past the cache and invalid slots.
Ops: ``fused_decode_attention`` / ``fused_prefill_attention`` against
the reference's — survivor tables and telemetry equal, outputs at 1e-5
— and equal, bit for bit, to the paged ops on the same rows laid out
under a shuffled page table. Model: ``prefill`` / ``decode_step`` logits
on ``init_cache`` at 1e-4 of the jitted reference (see
``test_torch_model.py`` for the tolerance), ``reset_decode_slots`` as
the reference's. Engine: ``ServeLoop(paged=False)`` greedy streams equal
to the reference's unpaged engine; unpaged ≡ paged and hybrid ≡ sync
with stochastic requests in the mix; a mid-prefill slot survives
interleaved decode ticks (the ``max_len`` sentinel); and the shapes the
contiguous path cannot serve are refused up front."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.core.energon_attention import _prefill_diag_blocks as j_diag
from repro.kernels import mpmrf_decode as jdec
from repro.kernels import mpmrf_prefill as jpre
from repro.kernels import ops as jops
from repro.models import LMModel as JaxLMModel
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch.configs import registry
from repro_torch.configs.registry import get_serve_config
from repro_torch.convert import convert_params
from repro_torch.core.energon_attention import _prefill_diag_blocks as t_diag
from repro_torch.kernels import mpmrf_decode as tdec
from repro_torch.kernels import mpmrf_prefill as tpre
from repro_torch.kernels import ops as tops
from repro_torch.models import LMModel
from repro_torch.runtime import Request, ServeLoop
from tests._torch_port import jax_model_config, n, t

BH, G, D, BK, NKB = 4, 4, 16, 16, 5
N_K = BK * NKB
N_Q, BQ = 32, 16
TOL = dict(atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# kernels: B5–B8 plain versions vs the reference's Pallas kernels
# --------------------------------------------------------------------------


def _codes(rng, filter_block=BK):
    k = rng.normal(size=(BH, N_K, D)).astype(np.float32)
    codes, scale = jq.quantize_int16_blocks(jnp.asarray(k), filter_block)
    return np.asarray(codes), np.asarray(scale)


def _q_planes(rng, rows, hi=4):
    half = 1 << (hi - 1)                 # the q plane of hi bits
    q_plane = rng.integers(-half, half, size=(BH, rows, D)).astype(np.int32)
    q_scale = rng.uniform(1e-5, 1e-3, size=(BH, rows, 1)).astype(np.float32)
    return q_plane, q_scale


def _qpos(rng):
    pos = np.stack([rng.integers(0, N_K - N_Q) + np.arange(N_Q)
                    for _ in range(BH)]).astype(np.int32)
    pos[1, -5:] = N_K                     # ragged tail: sentinel rows
    pos[3, :] = N_K                       # an idle slot: all sentinels
    return pos


@pytest.mark.parametrize("seed,round_bits", [
    pytest.param(0, (2, 4), id="0"), pytest.param(1, (2, 4), id="1"),
    pytest.param(0, (1, 8), id="0-lo1-hi8"),
    # lo = 0: the msb plane is the code's sign, the remainder reaches 255
    pytest.param(1, (0, 8), id="1-lo0-hi8"),
])
def test_b5_decode_filter_scores_bit_exact(seed, round_bits):
    rng = np.random.default_rng(seed)
    qp, qs = _q_planes(rng, G, round_bits[1])
    codes, scale = _codes(rng)
    # one row in its first block, one at the full cache, one past it
    # (an idle slot's max_len + 1 sentinel), one mid-block
    cl = np.array([1, N_K, N_K + 1, 37], np.int32)
    ref = jdec.mpmrf_decode_filter_scores(
        jnp.asarray(qp), jnp.asarray(qs), jnp.asarray(codes),
        jnp.asarray(scale), jnp.asarray(cl), round_bits=round_bits,
        key_block=BK, interpret=True)
    out = tdec.mpmrf_decode_filter_scores(
        t(qp), t(qs), t(codes), t(scale), t(cl), round_bits=round_bits,
        key_block=BK)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(n(r), n(o))
    assert (n(out[0])[0, 1:] == tdec.NEG_INF).all()
    assert (n(out[1])[2] > tdec.NEG_INF / 2).all()


@pytest.mark.parametrize("key_block", [BK, 2 * BK])
def test_b7_prefill_filter_scores_bit_exact(key_block):
    """``key_block = 2·filter_block``: every key tile spans two scale
    groups, so each key row must carry its own scale."""
    rng = np.random.default_rng(key_block)
    n_k = N_K if key_block == BK else N_K - BK   # divisible by the tile
    qp, qs = _q_planes(rng, N_Q)
    codes, scale = _codes(rng)
    codes = codes[:, :n_k]
    row_scale = np.repeat(scale, BK, axis=-1)[:, :n_k]
    qpos = np.minimum(_qpos(rng), n_k)
    ref = jpre.mpmrf_prefill_filter_scores(
        jnp.asarray(qp), jnp.asarray(qs), jnp.asarray(qpos),
        jnp.asarray(codes), jnp.asarray(row_scale), query_block=BQ,
        key_block=key_block, interpret=True)
    out = tpre.mpmrf_prefill_filter_scores(
        t(qp), t(qs), t(qpos), t(codes), t(row_scale), query_block=BQ,
        key_block=key_block)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(n(r), n(o))
    assert (n(out[1])[3] == tpre.NEG_INF).all()


def _kv(rng):
    return (rng.normal(size=(BH, N_K, D)).astype(np.float32),
            rng.normal(size=(BH, N_K, D)).astype(np.float32))


def test_b6_decode_gather_matches_pallas():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(BH, G, D)).astype(np.float32)
    k, v = _kv(rng)
    idx = rng.integers(0, NKB, size=(BH, 3)).astype(np.int32)
    val = (rng.uniform(size=(BH, 3)) < 0.75).astype(np.int32)
    val[0] = 0                           # a row with no valid slot → zeros
    val[2, 0], idx[2, 0] = 1, NKB - 1    # the last block under a sentinel
    cl = np.array([40, 77, N_K + 1, 33], np.int32)
    ref = jdec.decode_gather_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx),
        jnp.asarray(val), jnp.asarray(cl), key_block=BK, interpret=True)
    out = tdec.decode_gather_attention(
        t(q), t(k), t(v), t(idx), t(val), t(cl), key_block=BK)
    np.testing.assert_allclose(n(out), n(ref), **TOL)
    assert not n(out)[0].any()


def test_b8_prefill_gather_matches_pallas():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(BH, N_Q, D)).astype(np.float32)
    k, v = _kv(rng)
    shape = (BH, N_Q // BQ, 3)
    idx = rng.integers(0, NKB, size=shape).astype(np.int32)
    val = (rng.uniform(size=shape) < 0.75).astype(np.int32)
    qpos = _qpos(rng)
    ref = jpre.prefill_gather_attention(
        jnp.asarray(q), jnp.asarray(qpos), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(idx), jnp.asarray(val), query_block=BQ, key_block=BK,
        interpret=True)
    out = tpre.prefill_gather_attention(
        t(q), t(qpos), t(k), t(v), t(idx), t(val), query_block=BQ,
        key_block=BK)
    np.testing.assert_allclose(n(out), n(ref), **TOL)
    assert not n(out)[3].any()           # sentinel rows attend nothing


# --------------------------------------------------------------------------
# ops: the fused unpaged pipelines vs the reference, and vs paged
# --------------------------------------------------------------------------

B, H = 2, 2                              # slots × KV heads of the op tests


def _cache(rng, extent, filter_block=BK):
    """``[B, H, N_K, D]`` K/V zero past each slot's written extent, with
    the resident planes of the jitted reference's quantization."""
    live = (np.arange(N_K)[None, :] < np.asarray(extent)[:, None])
    live = live[:, None, :, None]
    k = rng.normal(size=(B, H, N_K, D)).astype(np.float32) * live
    v = rng.normal(size=(B, H, N_K, D)).astype(np.float32) * live
    codes, scale = jax.jit(jq.quantize_int16_blocks, static_argnums=1)(
        jnp.asarray(k), filter_block)
    return dict(k=k, v=v, codes=np.asarray(codes), scale=np.asarray(scale))


def _decode_case(seed=1, cl=(37, N_K + 1)):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, G, D)).astype(np.float32)
    cl = np.asarray(cl, np.int32)
    return q, cl, _cache(rng, np.minimum(cl, N_K))


def _decode_kw(ratio, cl):
    lb = None
    if ratio > 1.0:
        lb = np.asarray(
            np.ceil(-(-cl // BK) / ratio), np.int32).clip(min=1)
    return dict(key_block=BK, block_budget=max(1, math.ceil(NKB / ratio)),
                keep_all=ratio <= 1.0, telemetry=True), lb


@pytest.mark.parametrize("ratio", [1.0, 2.0, 4.0])
def test_fused_decode_matches_reference(ratio):
    q, cl, c = _decode_case()
    kw, lb = _decode_kw(ratio, cl)
    ref, ref_stats = jops.fused_decode_attention(
        jnp.asarray(q), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["codes"]), jnp.asarray(c["scale"]), jnp.asarray(cl),
        live_budget=None if lb is None else jnp.asarray(lb), **kw)
    out, stats = tops.fused_decode_attention(
        t(q), t(c["k"]), t(c["v"]), t(c["codes"]), t(c["scale"]), t(cl),
        live_budget=None if lb is None else t(lb), **kw)
    np.testing.assert_allclose(n(out), n(ref), **TOL)
    np.testing.assert_array_equal(n(stats), n(ref_stats))

    # the survivor tables both pipelines select from the same q planes
    q16 = jq.quantize_int16(jnp.asarray(q), axis=-1)
    qp = np.asarray(q16.bit_plane(4)).reshape(B * H, G, D)
    qs = np.asarray(q16.scale).reshape(B * H, G, 1)
    cl_bh = np.repeat(cl, H)
    args = (qp, qs, c["codes"].reshape(B * H, N_K, D),
            c["scale"].reshape(B * H, NKB), cl_bh)
    js = jdec.mpmrf_decode_filter_scores(
        *map(jnp.asarray, args), key_block=BK, interpret=True)
    ts = tdec.mpmrf_decode_filter_scores(*map(t, args), key_block=BK)
    sel = dict(alphas=(0.0, 0.0), key_block=BK,
               block_budget=kw["block_budget"], keep_all=kw["keep_all"],
               keep_first=True, keep_diagonal=True, heads=H,
               with_stats=True)
    ji = jops._fused_decode_select(
        *js, jnp.asarray(cl_bh),
        live_budget=None if lb is None else jnp.asarray(lb), **sel)
    ti = tops._fused_decode_select(
        *ts, t(cl_bh), live_budget=None if lb is None else t(lb), **sel)
    for a, b in zip(ji, ti):
        np.testing.assert_array_equal(n(a), n(b))


def _prefill_case(seed=3, filter_block=BK):
    rng = np.random.default_rng(seed)
    n_q = 16
    q = rng.normal(size=(B, H, n_q, D)).astype(np.float32)
    pos = np.stack([o + np.arange(n_q) for o in (24, 60)]).astype(np.int32)
    pos[1, -4:] = N_K                     # ragged tail: sentinel rows
    extent = np.where(pos < N_K, pos + 1, 0).max(axis=1)
    return q, pos, _cache(rng, extent, filter_block)


@pytest.mark.parametrize("ratio, key_block", [(2.0, BK), (4.0, BK),
                                              (2.0, 2 * BK)])
def test_fused_prefill_matches_reference(ratio, key_block):
    q, pos, c = _prefill_case()
    n_k = N_K - (N_K % key_block)
    c = {k: v[:, :, :n_k] if k != "scale" else v[:, :, :n_k // BK]
         for k, v in c.items()}
    pos = np.minimum(pos, n_k)
    budget = max(1, math.ceil(n_k // key_block / ratio))
    kw = dict(query_block=8, key_block=key_block, filter_block=BK,
              block_budget=budget, telemetry=True)
    ref, ref_stats = jops.fused_prefill_attention(
        jnp.asarray(q), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["codes"]), jnp.asarray(c["scale"]), jnp.asarray(pos),
        diag_blocks=j_diag(jnp.asarray(pos), 8, key_block, n_k), **kw)
    diag = t_diag(t(pos), 8, key_block, n_k)
    out, stats = tops.fused_prefill_attention(
        t(q), t(c["k"]), t(c["v"]), t(c["codes"]), t(c["scale"]), t(pos),
        diag_blocks=diag, **kw)
    np.testing.assert_allclose(n(out), n(ref), **TOL)
    np.testing.assert_array_equal(n(stats), n(ref_stats))

    n_q = q.shape[2]
    q16 = jq.quantize_int16(jnp.asarray(q), axis=-1)
    qp = np.asarray(q16.bit_plane(4)).reshape(B * H, n_q, D)
    qs = np.asarray(q16.scale).reshape(B * H, n_q, 1)
    qpos = np.repeat(pos, H, axis=0)
    row_scale = np.repeat(c["scale"], BK, axis=-1).reshape(B * H, n_k)
    args = (qp, qs, qpos, c["codes"].reshape(B * H, n_k, D), row_scale)
    js = jpre.mpmrf_prefill_filter_scores(
        *map(jnp.asarray, args), query_block=8, key_block=key_block,
        interpret=True)
    ts = tpre.mpmrf_prefill_filter_scores(
        *map(t, args), query_block=8, key_block=key_block)
    sel = dict(round_bits=(2, 4), alphas=(0.0, 0.0), query_block=8,
               key_block=key_block, block_budget=budget, keep_all=False,
               keep_first=True, keep_diagonal=True, heads=H,
               with_stats=True)
    ji = jops._fused_prefill_select(*js, diag_blocks=j_diag(
        jnp.asarray(pos), 8, key_block, n_k), **sel)
    ti = tops._fused_prefill_select(*ts, diag_blocks=diag, **sel)
    for a, b in zip(ji, ti):
        np.testing.assert_array_equal(n(a), n(b))


def _as_pages(c, seed):
    """The contiguous cache's rows under a shuffled block table: pool
    ``[H, P·BK, D]``, page scales ``[H, P]``, table ``[B, NKB]``."""
    num_pages = B * NKB + 3                # spare pages stay zero
    table = np.random.default_rng(seed).permutation(num_pages)
    table = table[:B * NKB].reshape(B, NKB).astype(np.int32)
    pool = {k: np.zeros((H, num_pages * BK, D), c[k].dtype)
            for k in ("k", "v", "codes")}
    scale = np.zeros((H, num_pages), np.float32)
    for b in range(B):
        for j in range(NKB):
            pg, rows = table[b, j], slice(j * BK, (j + 1) * BK)
            for key in pool:
                pool[key][:, pg * BK:(pg + 1) * BK] = c[key][b, :, rows]
            scale[:, pg] = c["scale"][b, :, j]
    return {k: t(v) for k, v in pool.items()}, t(scale), t(table)


def test_contiguous_equals_paged_bit_for_bit():
    """B5–B8's pipelines on the contiguous cache give exactly the paged
    pipelines' outputs and stats on the same rows laid out as pages."""
    q, cl, c = _decode_case(seed=7, cl=(50, 80))
    pool, scale, table = _as_pages(c, seed=8)
    kw, lb = _decode_kw(4.0, cl)
    kw["live_budget"] = t(lb)
    a = tops.fused_decode_attention(
        t(q), t(c["k"]), t(c["v"]), t(c["codes"]), t(c["scale"]), t(cl),
        **kw)
    b = tops.fused_paged_decode_attention(
        t(q), pool["k"], pool["v"], pool["codes"], scale, table, t(cl), **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    q, pos, c = _prefill_case(seed=9)
    pool, scale, table = _as_pages(c, seed=10)
    diag = t_diag(t(pos), 8, BK, N_K)
    kw = dict(query_block=8, key_block=BK, block_budget=2, telemetry=True,
              diag_blocks=diag)
    a = tops.fused_prefill_attention(
        t(q), t(c["k"]), t(c["v"]), t(c["codes"]), t(c["scale"]), t(pos),
        filter_block=BK, **kw)
    b = tops.fused_paged_prefill_attention(
        t(q), pool["k"], pool["v"], pool["codes"], scale, table, t(pos),
        **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# --------------------------------------------------------------------------
# model and engine
# --------------------------------------------------------------------------

MAX_LEN, CHUNK = 64, 8


@pytest.fixture(scope="module")
def models():
    cfg = get_serve_config("qwen3-14b", smoke=True)
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return cfg, jmodel, jparams, model, params


def test_prefill_and_decode_logits_match_reference(models):
    cfg, jmodel, jparams, model, params = models
    jcache = jmodel.init_cache(2, MAX_LEN)
    cache = model.init_cache(2, MAX_LEN)
    assert set(cache) == set(jcache) == {"k", "v", "k_codes", "k_scale"}
    for key in cache:
        assert tuple(cache[key].shape) == tuple(jcache[key].shape), key
    jprefill = jax.jit(jmodel.prefill)
    jdecode = jax.jit(jmodel.decode_step)
    rng = np.random.default_rng(0)
    lens = [24, 19]
    prompts = [rng.integers(1, cfg.vocab_size - 1, size=L) for L in lens]
    zero = np.zeros(2, np.int32)
    for c in range(3):
        toks = np.zeros((2, CHUNK), np.int32)
        pos = np.full((2, CHUNK), MAX_LEN, np.int32)   # sentinels
        for b, p in enumerate(prompts):
            part = p[c * CHUNK:(c + 1) * CHUNK]
            toks[b, :len(part)] = part
            pos[b, :len(part)] = c * CHUNK + np.arange(len(part))
        ref, jcache = jprefill(jparams, jcache, {
            "tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)},
            jnp.asarray(zero))
        out, cache = model.prefill(params, cache, {
            "tokens": t(toks), "positions": t(pos)}, t(zero))
        real = pos < MAX_LEN
        np.testing.assert_allclose(n(out)[real], n(ref)[real], atol=1e-4,
                                   rtol=1e-4)
    for key in ("k", "v", "k_scale"):
        np.testing.assert_allclose(n(cache[key]), n(jcache[key]), **TOL,
                                   err_msg=key)
    assert np.abs(n(cache["k_codes"]).astype(np.int32)
                  - np.asarray(jcache["k_codes"]).astype(np.int32)).max() <= 1

    idx = np.array(lens, np.int32)
    nxt = np.array([[5], [9]], np.int32)
    for step in range(3):
        if step == 2:
            idx[1] = MAX_LEN                  # the idle-slot sentinel
        ref, jcache = jdecode(jparams, jcache, {"tokens": jnp.asarray(nxt)},
                              jnp.asarray(idx))
        out, cache = model.decode_step(params, cache, {"tokens": t(nxt)},
                                       t(idx))
        np.testing.assert_allclose(n(out), n(ref), atol=1e-4, rtol=1e-4)
        nxt = np.asarray(ref[:, -1].argmax(-1), np.int32)[:, None]
        idx = np.minimum(idx + 1, MAX_LEN)
    for key in ("k", "v", "k_scale"):
        np.testing.assert_allclose(n(cache[key]), n(jcache[key]), **TOL,
                                   err_msg=key)


def test_reset_decode_slots_zeroes_exactly_the_admitted_slots(models):
    cfg, jmodel, _, model, _ = models
    rng = np.random.default_rng(4)
    jcache = jmodel.init_cache(3, MAX_LEN)
    filled = {k: rng.normal(size=v.shape).astype(np.asarray(v).dtype)
              for k, v in jcache.items()}
    mask = np.array([True, False, True])
    ref = jmodel.reset_decode_slots({k: jnp.asarray(v) for k, v in
                                     filled.items()}, jnp.asarray(mask))
    cache = model.reset_decode_slots({k: t(v) for k, v in filled.items()},
                                     t(mask))
    for key in filled:
        np.testing.assert_array_equal(n(cache[key]), n(ref[key]), key)
        assert not n(cache[key])[:, mask].any()
        np.testing.assert_array_equal(n(cache[key])[:, 1], filled[key][:, 1])
    dense = LMModel(dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, impl="dense")), device="cpu")
    kept = dense.reset_decode_slots({k: t(v) for k, v in filled.items()},
                                    t(mask))
    np.testing.assert_array_equal(n(kept["k"]), filled["k"])


def _trace(cfg, n_req=5, seed=7, stochastic=False, max_new=5):
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n_req):
        out.append(dict(
            uid=uid, max_new_tokens=max_new,
            prompt=[int(x) for x in rng.integers(
                1, cfg.vocab_size - 1, size=int(rng.integers(3, 30)))],
            temperature=0.9 if (stochastic and uid % 2) else 0.0,
        ))
    return out


def _serve(engine, trace, request_cls):
    for r in trace:
        engine.submit(request_cls(**r))
    done = engine.run_until_drained()
    return {r.uid: list(r.tokens_out) for r in done}


def _port(models, trace, **kw):
    cfg, _, _, model, params = models
    engine = ServeLoop(model, params, batch_slots=3, max_len=MAX_LEN,
                       eos_token=cfg.vocab_size - 1, prefill_chunk=CHUNK,
                       device="cpu", **kw)
    return _serve(engine, trace, Request), engine


def test_unpaged_greedy_streams_match_reference(models):
    cfg, jmodel, jparams, _, _ = models
    trace = _trace(cfg)
    ref_engine = JaxServeLoop(
        jmodel, jparams, batch_slots=3, max_len=MAX_LEN, paged=False,
        eos_token=cfg.vocab_size - 1, prefill_chunk=CHUNK,
    )
    ref = _serve(ref_engine, trace, JaxRequest)
    out, engine = _port(models, trace, paged=False)
    assert not engine.paged and engine.allocator is None
    assert out == ref
    assert engine.metrics.prefill_tokens == ref_engine.metrics.prefill_tokens


@pytest.mark.parametrize("stochastic", [False, True])
def test_unpaged_equals_paged(models, stochastic):
    trace = _trace(models[0], seed=8, stochastic=stochastic, max_new=8)
    paged, _ = _port(models, trace, paged=True, prefix_sharing=False)
    unpaged, _ = _port(models, trace, paged=False)
    assert unpaged == paged


def test_unpaged_hybrid_equals_sync(models):
    trace = _trace(models[0], seed=9, stochastic=True)
    hybrid, _ = _port(models, trace, paged=False, scheduler="hybrid")
    sync, _ = _port(models, trace, paged=False, scheduler="sync")
    assert hybrid == sync


def test_mid_prefill_slot_survives_decode_ticks(models):
    """Slot 1 prefills a long prompt chunk by chunk while slot 0 decodes:
    every decode tick steps slot 1 at the ``max_len`` sentinel, so its
    rows, codes and scales come out of the tick unchanged."""
    cfg, _, _, model, params = models
    engine = ServeLoop(model, params, batch_slots=2, max_len=MAX_LEN,
                       eos_token=cfg.vocab_size - 1, prefill_chunk=CHUNK,
                       paged=False, device="cpu")
    engine.submit(Request(uid=0, prompt=[3, 4, 5], max_new_tokens=8))
    engine.submit(Request(uid=1, prompt=list(range(1, 41)),
                          max_new_tokens=2))
    real_step = model.decode_step
    checked = []

    def step(params, cache, inputs, cache_index):
        before = {k: v[:, 1].clone() for k, v in cache.items()}
        out = real_step(params, cache, inputs, cache_index)
        if engine.slots[1] is not None and engine.slots[1].state == "prefill":
            assert int(cache_index[1]) == engine.max_len
            for k, v in before.items():
                assert torch.equal(cache[k][:, 1], v), k
            checked.append(1)
        return out

    model.decode_step = step
    try:
        engine.run_until_drained()
    finally:
        del model.decode_step
    assert len(checked) >= 3
    assert [len(r.tokens_out) for r in sorted(
        engine.completed, key=lambda r: r.uid)] == [8, 2]


def narrow_full_config(arch="qwen3-14b", smoke=False):
    """qwen3-14b's serving config (G = 5, key blocks of 64, query block
    128, planes from 1024 rows) at a width the CPU serves in seconds, as
    ``test_torch_serve.py`` builds it."""
    assert not smoke
    return dataclasses.replace(
        get_serve_config(arch), d_model=64, num_heads=10, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, dtype="float32",
    )


def test_serve_launcher_unpaged_runs_the_fused_kernels(monkeypatch):
    from repro_torch.launch import serve

    calls = {"prefill": 0, "decode": 0}

    def counted(kind, fn):
        def wrapper(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(registry, "get_serve_config", narrow_full_config)
    monkeypatch.setattr(tops, "fused_prefill_attention", counted(
        "prefill", tops.fused_prefill_attention))
    monkeypatch.setattr(tops, "fused_decode_attention", counted(
        "decode", tops.fused_decode_attention))
    engine = serve.main([
        "--arch", "qwen3-14b", "--layers", "3", "--device", "cpu",
        "--requests", "2", "--batch-slots", "2", "--prompt-len", "150",
        "--new-tokens", "2", "--unpaged",
    ])
    assert not engine.paged and not engine.sharing
    assert [len(r.tokens_out) for r in engine.completed] == [2, 2]
    # one sparse layer (layers 0-1 are the dense prefix)
    assert calls["prefill"] == engine.metrics.prefill_dispatches > 0
    assert calls["decode"] == engine.metrics.decode_dispatches > 0


@pytest.mark.parametrize("overrides, max_len, chunk, fault", [
    ({}, 4096, 256, "dense layers would mask 1280 folded rows"),
    ({"impl": "mpmrf_block"}, 4096, 256,
     "prefill layers off the fused kernels"),
    ({"impl": "mpmrf_row"}, 4096, 256, "prefill layers off the fused"),
    ({"impl": "bogus"}, 4096, 128, "impl='bogus' is not one of"),
])
def test_unpaged_refuses_shapes_off_the_path(overrides, max_len, chunk,
                                             fault):
    """What still fails mid-run is refused up front (the chunk_threshold
    masks of the layers off the fused kernels, an unknown impl); shapes
    the fused kernels do not take run the reference's fallbacks
    (``test_unpaged_serves_shapes_off_the_fused_kernels``)."""
    cfg = narrow_full_config()
    cfg = dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, **overrides))
    model = LMModel(cfg, device="cpu")
    with pytest.raises(ValueError, match=fault):
        ServeLoop(model, model.init(), max_len=max_len, prefill_chunk=chunk,
                  paged=False, device="cpu")


@pytest.mark.parametrize("overrides, max_len, chunk, fused", [
    # no resident planes below 1024 rows: the XLA block paths
    ({}, 128, 128, ()),
    # 320 folded rows off the query blocks: row prefill, fused decode
    ({}, 4096, 64, ("fused_decode_attention",)),
    # 4160 rows are not whole key blocks of 128: row prefill; decode
    # blocks of 64 stay fused
    ({"key_block": 128}, 4100, 128, ("fused_decode_attention",)),
])
def test_unpaged_serves_shapes_off_the_fused_kernels(monkeypatch, overrides,
                                                     max_len, chunk, fused):
    calls = {}
    for name in ("fused_prefill_attention", "fused_decode_attention"):
        real = getattr(tops, name)
        calls[name] = 0

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tops, name, counted)
    cfg = dataclasses.replace(narrow_full_config(), num_layers=3)
    cfg = dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, **overrides))
    model = LMModel(cfg, device="cpu")
    engine = ServeLoop(model, model.init(), batch_slots=1, max_len=max_len,
                       prefill_chunk=chunk, paged=False, eos_token=-1,
                       device="cpu")
    engine.submit(Request(uid=0, prompt=list(range(1, 71)),
                          max_new_tokens=2))
    assert [len(r.tokens_out) for r in engine.run_until_drained()] == [2]
    assert {k for k, v in calls.items() if v} == set(fused)


def test_unpaged_refuses_prefix_sharing(models):
    _, _, _, model, params = models
    with pytest.raises(ValueError, match="prefix_sharing requires"):
        ServeLoop(model, params, max_len=MAX_LEN, prefill_chunk=CHUNK,
                  paged=False, prefix_sharing=True, device="cpu")

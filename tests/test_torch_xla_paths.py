"""The port's torch selection and gather paths (the reference's XLA
paths) against the reference's, on the CPU: quantization's integer
products, ``core/filtering.py``'s row, block and decode selections,
``core/sparse_attention.py``'s gathers, every non-fused branch of the
four attention entry points, and fused ≡ XLA selection (serving on
these paths is ``test_torch_xla_serve.py``'s).

Sizes: head_dim 16, 64 keys, blocks of 16 (8 on the decode paths), so
budgets really prune. Every JAX side that quantizes runs under
``jax.jit`` (XLA multiplies by float32(1/32767), as the port does).

Tolerances: integer stages (accumulators, planes, keep masks from
identical inputs, survivor tables, tiers, stats) exactly; score planes
exactly (the same products in the same association); attention outputs
at fp32 atol = rtol = 1e-5; logits at 1e-4, as ``test_torch_model.py``
states."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filtering as jflt
from repro.core import quantization as jq
from repro.core import sparse_attention as jspa
from repro.runtime import paged_cache as jpgc
from repro_torch.core import filtering as tflt
from repro_torch.core import quantization as tq
from repro_torch.core import sparse_attention as tspa
from repro_torch.kernels import ops as tops
from repro_torch.runtime import paged_cache as tpgc
from tests._torch_port import jax_energon, n, t

JE = importlib.import_module("repro.core.energon_attention")
TE = importlib.import_module("repro_torch.core.energon_attention")

B, H, N, D, BLK = 2, 2, 64, 16, 16
TOL = dict(atol=1e-5, rtol=1e-5)


#: one element of every row is ±32767/8192, the absmax of each row, head
#: and key block (the rest lie within ±3.9), so every quantization scale
#: is exactly 2^-13, every score an integer times a power of two, and the
#: Eq. 3 sums exact in any order — selection is then the same in both
#: frameworks, ties on θ included (a float sum in another order would
#: flip them). The first array (q) carries it in dim 0 and zero in dim
#: 1, the others in dim 1 and zero in dim 0, so it adds nothing to q·k.
EXACT = 32767 / 8192


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(shapes):
        x = np.clip(rng.normal(size=s), -3.9, 3.9).astype(np.float32)
        at, zero = (0, 1) if i == 0 else (1, 0)
        x[..., at] = EXACT * rng.choice([-1.0, 1.0], size=s[:-1])
        x[..., zero] = 0.0
        out.append(x)
    return out


def _fields(res):
    """A FilterResult's arrays, as a pytree ``jax.jit`` can return."""
    return {k: v for k, v in vars(res).items() if v is not None}


def _eq(a, b):
    np.testing.assert_array_equal(n(a), n(b))


def _close(a, b, **tol):
    np.testing.assert_allclose(n(a), n(b), **(tol or TOL))


# --------------------------------------------------------------------------
# quantization: exact integer products
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8, 12])
def test_low_bit_scores_and_int_matmul_match_reference(bits):
    q, k = _normal(0, (B, H, N, D), (B, H, N, D))
    jq16 = jq.QuantizedTensor(*jax.jit(lambda x: dataclasses.astuple(
        jq.quantize_int16(x, axis=-1))[:2])(q), axis=-1)
    jk16 = jq.QuantizedTensor(*jax.jit(lambda x: dataclasses.astuple(
        jq.quantize_int16(x, axis=(-2, -1)))[:2])(k), axis=(-2, -1))
    tq16 = tq.quantize_int16(t(q), axis=-1)
    tk16 = tq.quantize_int16(t(k), axis=(-2, -1))
    _eq(tq16.codes, jq16.codes)
    _eq(tk16.codes, jk16.codes)
    ref = jq.low_bit_scores(jq16, jk16, bits)
    out = tq.low_bit_scores(tq16, tk16, bits)
    if bits <= 8:     # int32 accumulators, rescaled in one association
        _eq(out, ref)
        _eq(tq.int_qk_matmul(tq16.bit_plane(bits), tk16.bit_plane(bits),
                             (tq.plane_max(bits),) * 2),
            jq.int_qk_matmul(jq16.bit_plane(bits), jk16.bit_plane(bits)))
    else:             # f32 accumulation by design on both sides
        _close(out, ref, rtol=1e-5, atol=1e-6)
    _close(tq.fake_quantize(t(q), bits),
           jax.jit(jq.fake_quantize, static_argnums=1)(q, bits), rtol=0,
           atol=0)


def test_int_matmul_widens_past_the_f32_bound():
    """16-bit planes: d·32767² is far past 2^24, so the product runs in
    float64 and wraps to int32 as the reference's accumulators do."""
    rng = np.random.default_rng(1)
    a = rng.integers(-32767, 32768, size=(3, 5, 256)).astype(np.int32)
    b = rng.integers(-32767, 32768, size=(3, 7, 256)).astype(np.int32)
    _eq(tq.int_qk_matmul(t(a), t(b), (32767, 32767)),
        jq.int_qk_matmul(jnp.asarray(a), jnp.asarray(b)))
    _eq(tq.int_qk_matmul(t(a), t(b)), jq.int_qk_matmul(jnp.asarray(a),
                                                       jnp.asarray(b)))


def test_int_matmul_refuses_tf32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="MP-MRF integer products"):
            tq.int_qk_matmul(torch.ones(2, 4, dtype=torch.int32),
                             torch.ones(3, 4, dtype=torch.int32), (8, 2))
    finally:
        torch.set_float32_matmul_precision(prev)


def test_rescale_scores_keeps_the_reference_association():
    rng = np.random.default_rng(2)
    acc = rng.integers(-2000, 2000, size=(B, H, 8, 12)).astype(np.int32)
    qs = rng.uniform(1e-5, 1e-3, size=(B, H, 8, 1)).astype(np.float32)
    ks = rng.uniform(1e-5, 1e-3, size=(B, H, 12, 1)).astype(np.float32)
    _eq(tq.rescale_scores(t(acc), t(qs), t(ks)),
        jq.rescale_scores(jnp.asarray(acc), jnp.asarray(qs),
                          jnp.asarray(ks)))


# --------------------------------------------------------------------------
# filtering: planes, row / block / decode selection
# --------------------------------------------------------------------------


def _mcfg(mod, **kw):
    base = dict(granularity="block", query_block=BLK, key_block=BLK,
                block_budget=2)
    base.update(kw)
    return mod.MPMRFConfig(**base)


@pytest.mark.parametrize("reuse", [True, False])
@pytest.mark.parametrize("round_bits", [(2, 4), (1, 3, 8)])
def test_round_score_planes_bit_exact(reuse, round_bits):
    q, k = _normal(3, (B, H, N, D), (B, H, N, D))
    kw = dict(round_bits=round_bits, alphas=(0.0,) * len(round_bits),
              reuse_partial=reuse)
    jcfg, tcfg = _mcfg(jflt, **kw), _mcfg(tflt, **kw)

    @jax.jit
    def ref(q, k):
        return list(jflt._round_score_planes(
            jq.quantize_int16(q, axis=-1),
            jq.quantize_int16(k, axis=(-2, -1)), jcfg))

    out = list(tflt._round_score_planes(
        tq.quantize_int16(t(q), axis=-1),
        tq.quantize_int16(t(k), axis=(-2, -1)), tcfg))
    assert len(out) == len(round_bits)
    for o, r in zip(out, ref(q, k)):
        _eq(o, r)


def _causal(n_q=N, n_k=N):
    return np.broadcast_to(np.tril(np.ones((n_q, n_k), bool)),
                           (B, H, n_q, n_k)).copy()


@pytest.mark.parametrize("keep_all", [False, True])
def test_row_select_matches_reference(keep_all):
    q, k = _normal(4, (B, H, N, D), (B, H, N, D))
    valid = _causal()
    kw = dict(granularity="row", keep_all=keep_all)
    ref = jax.jit(lambda q, k, m: _fields(jflt.mpmrf_row_select(
        q, k, jflt.MPMRFConfig(**kw), m)))(q, k, valid)
    out = tflt.mpmrf_row_select(t(q), t(k), tflt.MPMRFConfig(**kw), t(valid))
    _eq(out.keep_mask, ref["keep_mask"])
    _eq(out.scores, ref["scores"])
    assert not (n(out.keep_mask) & ~valid).any()


def test_pool_and_mask_helpers_match_reference():
    (s,) = _normal(5, (B, H, N, N))
    valid = _causal()
    for o, r in zip(tflt.pool_block_scores(t(s), 16, 8, t(valid)),
                    jflt.pool_block_scores(s, 16, 8, valid)):
        _eq(o, r)
    m = np.random.default_rng(6).uniform(size=(B, H, 4, 8)) < 0.5
    _eq(tflt.expand_block_mask(t(m), 16, 8), jflt.expand_block_mask(m, 16, 8))
    for window in (0, 1, 24):
        _eq(tflt.sliding_window_valid_mask(N, N, window, 8),
            jflt.sliding_window_valid_mask(N, N, window, 8))


@pytest.mark.parametrize("case", ["fresh", "resident", "diag", "keep_all"])
def test_block_select_matches_reference(case):
    q, k = _normal(7, (B, H, N, D), (B, H, N, D))
    valid = _causal()
    kw = dict(keep_all=case == "keep_all")
    diag = k_codes = k_scale = None
    if case == "diag":
        diag = np.array([[0, 1, 1, 3], [2, 2, 3, 3]], np.int32)
    if case == "resident":
        k_codes, k_scale = (n(x) for x in tq.quantize_int16_blocks(t(k), 8))

    @jax.jit
    def ref(q, k, valid, diag, codes, scale):
        kq = None if codes is None else jq.blockwise_quantized_view(
            codes, scale, 8)
        res = jflt.mpmrf_block_select(q, k, _mcfg(jflt, **kw), valid,
                                      diag_blocks=diag, k_quant=kq,
                                      with_stats=True)
        return dict(_fields(res), stats=jflt.selection_stats(res))

    r = ref(q, k, valid, diag, k_codes, k_scale)
    kq = None if k_codes is None else tq.blockwise_quantized_view(
        t(k_codes), t(k_scale), 8)
    o = tflt.mpmrf_block_select(
        t(q), t(k), _mcfg(tflt, **kw), t(valid),
        diag_blocks=None if diag is None else t(diag), k_quant=kq,
        with_stats=True)
    for name in ("keep_mask", "block_indices", "block_valid", "sel_tier",
                 "live_mask", "scores"):
        _eq(getattr(o, name), r[name])
    _eq(tflt.selection_stats(o), r["stats"])


def _decode_case(seed, n_k=N, g=3, bk=8):
    q, k, v = _normal(seed, (B, H, g, D), (B, H, n_k, D), (B, H, n_k, D))
    cl = np.array([13, n_k], np.int32)
    valid = np.broadcast_to(
        (np.arange(n_k)[None, :] < cl[:, None])[:, None, None, :],
        (B, H, g, n_k)).copy()
    codes, scale = (n(x) for x in tq.quantize_int16_blocks(t(k), bk))
    return q, k, v, cl, valid, codes, scale


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("live", [False, True])
def test_decode_block_select_matches_reference(resident, live):
    q, k, _, cl, valid, codes, scale = _decode_case(8)
    lb = np.array([1, 3], np.int32) if live else None
    kw = dict(query_block=1, key_block=8, block_budget=4)

    @jax.jit
    def ref(q, k, valid, cl, codes, scale, lb):
        kq = None if codes is None else jq.blockwise_quantized_view(
            codes, scale, 8)
        return _fields(jflt.mpmrf_decode_block_select(
            q, k, _mcfg(jflt, **kw), valid, cl, k_quant=kq, live_budget=lb,
            with_stats=True))

    args = (codes, scale) if resident else (None, None)
    r = ref(q, k, valid, cl, *args, lb)
    kq = tq.blockwise_quantized_view(t(codes), t(scale), 8) if resident \
        else None
    o = tflt.mpmrf_decode_block_select(
        t(q), t(k), _mcfg(tflt, **kw), t(valid), t(cl), k_quant=kq,
        live_budget=None if lb is None else t(lb), with_stats=True)
    for name in ("keep_mask", "block_indices", "block_valid", "sel_tier",
                 "scores"):
        _eq(getattr(o, name), r[name])


def _paged(x, table, ps):
    """``[B, KV, n, ...]`` logical rows → the pool ``[KV, pages·ps, ...]``
    that ``table`` spells (unmapped pages left zero)."""
    b, kv, n_k = x.shape[:3]
    mb = n_k // ps
    pages = int(table.max()) + 1
    pool = np.zeros((kv, pages, ps) + x.shape[3:], x.dtype)
    for s in range(b):
        for j in range(mb):
            pool[:, table[s, j]] = x[s, :, j * ps:(j + 1) * ps]
    return pool.reshape((kv, pages * ps) + x.shape[3:])


def _table(seed, mb=N // 8):
    perm = np.random.default_rng(seed).permutation(B * mb) + 1
    return perm.reshape(B, mb).astype(np.int32)


@pytest.mark.parametrize("resident", [False, True])
def test_paged_block_select_equals_unpaged_and_reference(resident):
    q, k, _, cl, valid, codes, scale = _decode_case(9)
    table = _table(0)
    cache = {"k": _paged(k, table, 8)}
    if resident:
        cache["k_codes"] = _paged(codes, table, 8)
        cache["k_scale"] = _paged(scale[..., None], table, 1)[..., 0]
    kw = dict(query_block=1, key_block=8, block_budget=4)
    r = jax.jit(lambda q, c, bt, m, cl: _fields(jflt.mpmrf_paged_block_select(
        q, c, bt, _mcfg(jflt, **kw), m, cl)))(q, cache, table, valid, cl)
    o = tflt.mpmrf_paged_block_select(
        t(q), {k_: t(v_) for k_, v_ in cache.items()}, t(table),
        _mcfg(tflt, **kw), t(valid), t(cl))
    kq = tq.blockwise_quantized_view(t(codes), t(scale), 8) if resident \
        else None
    u = tflt.mpmrf_decode_block_select(t(q), t(k), _mcfg(tflt, **kw),
                                       t(valid), t(cl), k_quant=kq)
    for name in ("block_indices", "block_valid", "scores"):
        _eq(getattr(o, name), r[name])
        _eq(getattr(o, name), getattr(u, name))


# --------------------------------------------------------------------------
# sparse attention: masked, block gathers (full-sequence and decode)
# --------------------------------------------------------------------------


def test_masked_and_block_gather_attention_match_reference():
    q, k, v = _normal(10, *[(B, H, N, D)] * 3)
    valid = _causal()
    rng = np.random.default_rng(11)
    keep = valid & (rng.uniform(size=valid.shape) < 0.6)
    keep[0, 0, 5] = False                    # a row with nothing kept
    _close(tspa.masked_sparse_attention(t(q), t(k), t(v), t(keep)),
           jspa.masked_sparse_attention(q, k, v, keep))
    idx = rng.integers(0, N // 8, size=(B, H, N // BLK, 3)).astype(np.int32)
    bval = (rng.uniform(size=idx.shape) < 0.8).astype(np.int32)
    for m in (valid, None):
        _close(tspa.block_gather_attention(
                   t(q), t(k), t(v), t(idx), None if m is None else t(m),
                   BLK, 8, block_valid=t(bval)),
               jspa.block_gather_attention(q, k, v, idx, m, BLK, 8,
                                           block_valid=bval))


@pytest.mark.parametrize("window", [None, 20])
def test_decode_gathers_match_reference_and_paged_equals_unpaged(window):
    q, k, v, cl, valid, _, _ = _decode_case(12)
    rng = np.random.default_rng(13)
    idx = rng.integers(0, N // 8, size=(B, H, 1, 4)).astype(np.int32)
    bval = (rng.uniform(size=idx.shape) < 0.8).astype(np.int32)
    table = _table(1)
    ref = jspa.decode_block_gather_attention(q, k, v, idx, bval, cl, 8,
                                             window=window)
    out = tspa.decode_block_gather_attention(
        t(q), t(k), t(v), t(idx), t(bval), t(cl), 8, window=window)
    paged = tspa.paged_decode_block_gather_attention(
        t(q), t(_paged(k, table, 8)), t(_paged(v, table, 8)), t(idx),
        t(bval), t(table), t(cl), 8, window=window)
    jpaged = jspa.paged_decode_block_gather_attention(
        q, _paged(k, table, 8), _paged(v, table, 8), idx, bval, table, cl,
        8, window=window)
    _close(out, ref)
    _close(paged, jpaged)
    _eq(paged, out)
    _eq(tpgc.compose_physical_blocks(t(table), t(idx[..., 0, :])),
        jpgc.compose_physical_blocks(table, idx[..., 0, :]))
    _close(tspa.decode_sparse_attention(t(q), t(k), t(v), t(valid)),
           jspa.decode_sparse_attention(q, k, v, valid))


# --------------------------------------------------------------------------
# the entry points' non-fused branches
# --------------------------------------------------------------------------


def _jax_attention(cfg, q, k, v, **kw):
    jcfg = jax_energon(cfg)
    statics = {k_: v_ for k_, v_ in kw.items()
               if not isinstance(v_, (np.ndarray, dict))}
    arrays = {k_: v_ for k_, v_ in kw.items() if k_ not in statics}
    fn = jax.jit(lambda q, k, v, a: JE.energon_attention(
        q, k, v, jcfg, **statics, **a))
    return fn(q, k, v, arrays)


def _tcall(fn, *args, **kw):
    conv = lambda x: (t(x) if isinstance(x, np.ndarray) else
                      {k_: t(v_) for k_, v_ in x.items()}
                      if isinstance(x, dict) else x)
    return fn(*[conv(a) for a in args], **{k_: conv(v_)
                                           for k_, v_ in kw.items()})


@pytest.mark.parametrize("impl", ["dense", "mpmrf_row", "mpmrf_block",
                                  "pallas"])
@pytest.mark.parametrize("case", ["window", "kv_length", "q_positions",
                                  "q_positions_resident", "q_offset"])
def test_energon_attention_branches_match_reference(impl, case):
    q, k, v = _normal(14, *[(B, H, N, D)] * 3)
    cfg = TE.EnergonConfig(impl=impl, query_block=BLK, key_block=BLK,
                           pruning_ratio=2.0, decode_key_block=BLK)
    kw = dict(layer_index=5, telemetry=True)
    if case == "window":
        kw["window"] = 24
    elif case == "kv_length":
        kw["kv_length"] = np.array([40, N], np.int32)
    elif case == "q_offset":
        q = q[:, :, :32].copy()
        kw["q_offset"] = 32
    else:
        pos = np.stack([np.arange(20, 52), np.r_[np.arange(40, 60),
                                                 np.full(12, N)]]
                       ).astype(np.int32)
        q = q[:, :, :32].copy()
        kw["q_positions"] = pos
        if case == "q_positions_resident":
            codes, scale = tq.quantize_int16_blocks(t(k), BLK)
            kw["filter_cache"] = {"codes": n(codes), "scale": n(scale)}
    ref, rstats = _jax_attention(cfg, q, k, v, **kw)
    out, stats = _tcall(TE.energon_attention, q, k, v, cfg, **kw)
    if "q_positions" in kw:           # sentinel rows are the caller's
        real = (kw["q_positions"] < N)[:, None, :, None]
        out, ref = n(out) * real, np.asarray(ref) * real
    _close(out, ref)
    _eq(stats, rstats)


@pytest.mark.parametrize("impl", ["mpmrf_row", "mpmrf_block", "pallas"])
@pytest.mark.parametrize("case", ["plain", "resident", "window", "rho1",
                                  "rescore"])
def test_decode_entry_points_match_reference(impl, case):
    """``energon_decode_attention`` and the paged twin on every non-fused
    branch (the fused one only where its rule holds: ``pallas`` with
    planes), against the reference; paged ≡ unpaged bit for bit."""
    q, k, v, cl, _, codes, scale = _decode_case(15)
    cfg = TE.EnergonConfig(impl=impl, pruning_ratio=2.0, decode_key_block=8,
                           min_prune_layer=0,
                           reuse_partial=case != "rescore")
    window = None
    fc = None
    if case in ("resident", "rescore"):
        fc = {"codes": codes, "scale": scale}
    elif case == "window":
        window = 20
        fc = {"codes": codes, "scale": scale}
    elif case == "rho1":
        cfg = dataclasses.replace(cfg, pruning_ratio=1.0)
    jcfg = jax_energon(cfg)
    ref, rstats = jax.jit(lambda q, k, v, cl, fc: JE.energon_decode_attention(
        q, k, v, cl, jcfg, window=window, filter_cache=fc,
        telemetry=True))(q, k, v, cl, fc)
    out, stats = _tcall(TE.energon_decode_attention, q, k, v, cl, cfg,
                        window=window, filter_cache=fc, telemetry=True)
    _close(out, ref)
    _eq(stats, rstats)
    table = _table(2)
    cache = {"k": _paged(k, table, 8), "v": _paged(v, table, 8)}
    if fc is not None:
        cache["k_codes"] = _paged(codes, table, 8)
        cache["k_scale"] = _paged(scale[..., None], table, 1)[..., 0]
    pref, pstats = jax.jit(
        lambda q, c, bt, cl: JE.energon_paged_decode_attention(
            q, c, bt, cl, jcfg, window=window, telemetry=True)
    )(q, cache, table, cl)
    paged, tstats = _tcall(TE.energon_paged_decode_attention, q, cache,
                           table, cl, cfg, window=window, telemetry=True)
    _close(paged, pref)
    _eq(tstats, pstats)
    _eq(paged, out)


def _prefill_case(seed, ps=8, mb=8, n_q=32):
    n_k = ps * mb
    q, k, v = _normal(seed, (B, H, n_q, D), (B, H, n_k, D), (B, H, n_k, D))
    pos = np.stack([np.arange(24, 24 + n_q),
                    np.r_[np.arange(40, 40 + n_q - 10), np.full(10, n_k)]]
                   ).astype(np.int32)
    # the cache holds rows up to each slot's extent, zeros past it
    extent = np.where(pos < n_k, pos + 1, 0).max(1)
    live = (np.arange(n_k)[None, :] < extent[:, None])[:, None, :, None]
    k, v = k * live, v * live
    codes, scale = (n(x) for x in tq.quantize_int16_blocks(t(k), ps))
    return q, k, v, pos, codes, scale


@pytest.mark.parametrize("impl,key_block", [
    ("mpmrf_block", 8), ("mpmrf_row", 8), ("pallas", 16), ("dense", 8),
])
def test_paged_prefill_off_the_fused_kernels_matches_reference(impl,
                                                               key_block):
    """Paged prefill outside the fused rule (``pallas`` with key tiles of
    two pages) takes the logical gather then ``energon_attention`` at
    ``q_positions`` with the gathered planes, as the reference does."""
    q, k, v, pos, codes, scale = _prefill_case(16)
    cfg = TE.EnergonConfig(impl=impl, pruning_ratio=2.0, query_block=16,
                           key_block=key_block, decode_key_block=8,
                           min_prune_layer=0)
    table = _table(3)
    cache = {"k": _paged(k, table, 8), "v": _paged(v, table, 8),
             "k_codes": _paged(codes, table, 8),
             "k_scale": _paged(scale[..., None], table, 1)[..., 0]}
    jcfg = jax_energon(cfg)
    ref, rstats = jax.jit(
        lambda q, c, bt, p: JE.energon_paged_prefill_attention(
            q, c, bt, p, jcfg, telemetry=True))(q, cache, table, pos)
    out, stats = _tcall(TE.energon_paged_prefill_attention, q, cache, table,
                        pos, cfg, telemetry=True)
    real = (pos < k.shape[2])[:, None, :, None]
    _close(n(out) * real, np.asarray(ref) * real)
    _eq(stats, rstats)


# --------------------------------------------------------------------------
# fused ≡ XLA selection (the reference's tests/test_kernels.py contracts)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [2.0, 4.0])
def test_fused_decode_matches_xla_decode(ratio):
    q, k, v, cl, valid, codes, scale = _decode_case(17, g=4)
    fc = {"codes": codes, "scale": scale}
    outs = []
    for impl in ("mpmrf_block", "pallas"):
        cfg = TE.EnergonConfig(impl=impl, pruning_ratio=ratio,
                               decode_key_block=8, min_prune_layer=0)
        outs.append(_tcall(TE.energon_decode_attention, q, k, v, cl, cfg,
                           filter_cache=fc, telemetry=True))
    _close(outs[1][0], outs[0][0])
    _eq(outs[1][1], outs[0][1])
    # the survivor tables, bit for bit: the fused plan's selection from
    # the kernel's planes against the XLA block selection
    cfg = TE.EnergonConfig(impl="pallas", pruning_ratio=ratio,
                           decode_key_block=8)
    budget, keep_all, live, mcfg = TE._decode_block_plan(cfg, N, t(cl))
    xla = tflt.mpmrf_decode_block_select(
        t(q), t(k), mcfg, t(valid), t(cl), live_budget=live,
        k_quant=tq.blockwise_quantized_view(t(codes), t(scale), 8))
    from repro_torch.kernels import mpmrf_decode as dk

    q16 = tq.quantize_int16(t(q), axis=-1)
    cl_bh = t(cl).repeat_interleave(H)
    s0, s1 = dk.mpmrf_decode_filter_scores(
        q16.bit_plane(4).reshape(B * H, 4, D), q16.scale.reshape(B * H, 4, 1),
        t(codes).reshape(B * H, N, D), t(scale).reshape(B * H, -1), cl_bh,
        round_bits=(2, 4), key_block=8)
    idx, val, _ = tops._fused_decode_select(
        s0, s1, cl_bh, alphas=(0.0, 0.0), key_block=8, block_budget=budget,
        keep_all=keep_all, keep_first=True, keep_diagonal=True,
        live_budget=live, heads=H)
    _eq(idx, xla.block_indices.reshape(B * H, -1))
    _eq(val, xla.block_valid.reshape(B * H, -1))


@pytest.mark.parametrize("ratio", [1.0, 2.0, 4.0])
def test_fused_prefill_matches_xla_prefill(ratio):
    q, k, v, pos, codes, scale = _prefill_case(18, ps=16, mb=4)
    fc = {"codes": codes, "scale": scale}
    outs = []
    for impl in ("mpmrf_block", "pallas"):
        cfg = TE.EnergonConfig(impl=impl, pruning_ratio=ratio,
                               query_block=16, key_block=16,
                               decode_key_block=16, min_prune_layer=0)
        outs.append(_tcall(TE.energon_attention, q, k, v, cfg,
                           q_positions=pos, filter_cache=fc, telemetry=True))
    real = (pos < k.shape[2])[:, None, :, None]
    _close(n(outs[1][0]) * real, n(outs[0][0]) * real)
    _eq(outs[1][1], outs[0][1])
    if ratio == 1.0:                 # keep everything ⇒ exactly dense
        dense = _tcall(TE.energon_attention, q, k, v,
                       TE.EnergonConfig(impl="dense"), q_positions=pos)
        _close(n(outs[1][0]) * real, n(dense) * real)

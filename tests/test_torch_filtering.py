"""``FilterResult.survivor_fraction``: the per-round fraction of keys (or
blocks) that survive MP-MRF's rounds, the paper's pruning ratio.

The reference's own checks (``tests/test_filtering.py``) run on the
port: mean filtering keeps about half the keys in round 0 and a quarter
in round 1, and a round only shrinks the survivors. Then every path
that fills the field in the reference fills it in the port with the
same numbers, on the same inputs (``test_torch_xla_paths``' q / k,
whose quantization scales are exactly 2^-13, so both frameworks'
int16 codes and Eq. 3 sums agree and so do their selections): row
(paper-faithful, and ``keep_all``), block (fresh, resident planes, the
diagonal override), the prefill rule on pooled planes, decode (fresh /
resident, a live budget) and paged decode. The fused ops keep no
rounds: their field is empty, ``scores[..., :0]``, as the reference's
``s1[..., :0]``. Fractions are compared exactly (counts over counts in
f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # optional dev dep — property cases skip
    from _hypothesis_fallback import given, settings, st

from repro.core import filtering as jflt
from repro.core import quantization as jq
from repro_torch.core import filtering as tflt
from repro_torch.core import quantization as tq
from tests._torch_port import n, t
from tests.test_torch_xla_paths import (
    B, D, H, N, _causal, _decode_case, _fields, _mcfg, _normal, _paged,
    _table,
)


def _qkv(n_tok=256, d=32, bh=(2, 2), seed=0):
    """The reference test's inputs (``tests/test_filtering.py::_qkv``)."""
    rng = np.random.default_rng(seed)
    mk = lambda s: torch.from_numpy(                          # noqa: E731
        rng.normal(size=(*bh, n_tok, d)).astype(np.float32))
    return mk(1), mk(2)


def _eq(a, b):
    np.testing.assert_array_equal(n(a), n(b))


def test_mean_filtering_prunes_about_half_per_round():
    q, k = _qkv()
    res = tflt.mpmrf_row_select(q, k, tflt.MPMRFConfig())
    fracs = res.survivor_fraction.reshape(2, -1).mean(dim=1)
    assert res.survivor_fraction.shape == (2, 2, 2, 256)
    assert 0.35 < float(fracs[0]) < 0.65          # round 0 ~50%
    assert 0.1 < float(fracs[1]) < 0.4            # round 1 ~25%


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_property_rounds_shrink_selection(seed):
    """Each filtering round can only shrink the survivor set."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(1, 2, 64, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 64, 16)).astype(np.float32))
    res = tflt.mpmrf_row_select(q, k, tflt.MPMRFConfig(keep_first=False))
    f = res.survivor_fraction
    assert bool((f[0] >= f[1]).all())


@pytest.mark.parametrize("keep_all", [False, True])
def test_row_fractions_equal_the_reference(keep_all):
    q, k = _normal(4, (B, H, N, D), (B, H, N, D))
    valid = _causal()
    kw = dict(granularity="row", keep_all=keep_all)
    ref = jax.jit(lambda q, k, m: jflt.mpmrf_row_select(
        q, k, jflt.MPMRFConfig(**kw), m).survivor_fraction)(q, k, valid)
    out = tflt.mpmrf_row_select(t(q), t(k), tflt.MPMRFConfig(**kw),
                                t(valid))
    assert out.survivor_fraction.dtype == torch.float32
    _eq(out.survivor_fraction, ref)
    # the split row path's rule on the rounds' planes: the same numbers
    q16, k16 = tq.quantize_int16(t(q), axis=-1), tq.quantize_int16(
        t(k), axis=(-2, -1))
    planes = tflt.row_round_scores(q16, k16, tflt.MPMRFConfig(**kw))
    split = tflt.row_select_from_rounds(planes, tflt.MPMRFConfig(**kw),
                                        t(valid))
    _eq(split.survivor_fraction, ref)


@pytest.mark.parametrize("case", ["fresh", "resident", "diag", "keep_all"])
def test_block_fractions_equal_the_reference(case):
    q, k = _normal(7, (B, H, N, D), (B, H, N, D))
    valid = _causal()
    kw = dict(keep_all=case == "keep_all")
    diag = codes = scale = None
    if case == "diag":
        diag = np.array([[0, 1, 1, 3], [2, 2, 3, 3]], np.int32)
    if case == "resident":
        codes, scale = (n(x) for x in tq.quantize_int16_blocks(t(k), 8))

    @jax.jit
    def ref(q, k, valid, diag, codes, scale):
        kq = None if codes is None else jq.blockwise_quantized_view(
            codes, scale, 8)
        return jflt.mpmrf_block_select(
            q, k, _mcfg(jflt, **kw), valid, diag_blocks=diag,
            k_quant=kq).survivor_fraction

    r = ref(q, k, valid, diag, codes, scale)
    kq = None if codes is None else tq.blockwise_quantized_view(
        t(codes), t(scale), 8)
    o = tflt.mpmrf_block_select(
        t(q), t(k), _mcfg(tflt, **kw), t(valid),
        diag_blocks=None if diag is None else t(diag), k_quant=kq)
    assert o.survivor_fraction.shape == r.shape
    _eq(o.survivor_fraction, r)


def test_prefill_plane_rule_fractions_equal_the_reference():
    """The rule the fused prefill hands its pooled planes to."""
    rng = np.random.default_rng(11)
    planes = [np.round(rng.normal(size=(B, H, 4, 8)) * 64).astype(np.float32)
              for _ in range(2)]
    blk_valid = np.tril(np.ones((4, 8), bool), 1)[None, None].repeat(
        B, 0).repeat(H, 1)
    for p in planes:
        p[~blk_valid] = -1e30
    r = jflt.prefill_block_select_from_planes(
        [jnp.asarray(p) for p in planes], jnp.asarray(blk_valid),
        _mcfg(jflt)).survivor_fraction
    o = tflt.prefill_block_select_from_planes(
        [t(p) for p in planes], t(blk_valid), _mcfg(tflt))
    _eq(o.survivor_fraction, r)


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("live", [False, True])
def test_decode_fractions_equal_the_reference(resident, live):
    q, k, _, cl, valid, codes, scale = _decode_case(8)
    lb = np.array([1, 3], np.int32) if live else None
    kw = dict(query_block=1, key_block=8, block_budget=4)

    @jax.jit
    def ref(q, k, valid, cl, codes, scale, lb):
        kq = None if codes is None else jq.blockwise_quantized_view(
            codes, scale, 8)
        return jflt.mpmrf_decode_block_select(
            q, k, _mcfg(jflt, **kw), valid, cl, k_quant=kq,
            live_budget=lb).survivor_fraction

    args = (codes, scale) if resident else (None, None)
    r = ref(q, k, valid, cl, *args, lb)
    kq = tq.blockwise_quantized_view(t(codes), t(scale), 8) if resident \
        else None
    o = tflt.mpmrf_decode_block_select(
        t(q), t(k), _mcfg(tflt, **kw), t(valid), t(cl), k_quant=kq,
        live_budget=None if lb is None else t(lb))
    _eq(o.survivor_fraction, r)


def test_paged_fractions_equal_unpaged_and_the_reference():
    q, k, _, cl, valid, codes, scale = _decode_case(9)
    table = _table(0)
    cache = {"k": _paged(k, table, 8), "k_codes": _paged(codes, table, 8),
             "k_scale": _paged(scale[..., None], table, 1)[..., 0]}
    kw = dict(query_block=1, key_block=8, block_budget=4)
    r = jax.jit(lambda q, c, bt, m, cl: _fields(jflt.mpmrf_paged_block_select(
        q, c, bt, _mcfg(jflt, **kw), m, cl)))(q, cache, table, valid, cl)
    o = tflt.mpmrf_paged_block_select(
        t(q), {k_: t(v_) for k_, v_ in cache.items()}, t(table),
        _mcfg(tflt, **kw), t(valid), t(cl))
    u = tflt.mpmrf_decode_block_select(t(q), t(k), _mcfg(tflt, **kw),
                                       t(valid), t(cl))
    _eq(o.survivor_fraction, r["survivor_fraction"])
    _eq(o.survivor_fraction, u.survivor_fraction)


def test_a_selection_without_rounds_has_an_empty_fraction():
    """The fused ops' results (``kernels/ops.py``) keep no rounds: the
    reference hands them ``s1[..., :0]``."""
    scores = torch.zeros(2, 3, 1, 5)
    res = tflt.FilterResult(keep_mask=scores > 0, block_indices=None,
                            scores=scores)
    assert res.survivor_fraction.shape == (2, 3, 1, 0)

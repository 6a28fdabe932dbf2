"""The port's Threefry sampler (``repro_torch.core.prng``) against jax
0.9's partitionable Threefry-2x32, and ``ServeLoop``'s stochastic
streams against the reference engine's.

* ``PRNGKey``, ``fold_in``, ``split`` and ``random_bits`` bit for bit,
  over hypothesis-drawn seeds, uids and shapes up to a 152064-wide
  vocabulary row (qwen3's); the key after n samples equals the
  reference's ``_advance_key(fold_in(base, uid), n)``.
* ``uniform`` (float32) bit for bit on ``[0, 1)``, ``[tiny, 1)`` (the
  Gumbel draw's) and a range whose scaling XLA fuses into a
  multiply-add.
* ``gumbel`` (``-log(-log(u))``): each of its two logs within one ulp
  of XLA's on the same operand, so a draw is within two ulps of the
  outer log plus the inner log's ulp carried through it (``|Δg| ≤
  2·ulp(g) + ulp(l)/|l|``, l = log u); near g = 0 (u ≈ 1/e) that is
  many of g's own ulps, as XLA's own value is many ulps from the exact
  one there. Most draws are equal bit for bit.
* ``categorical`` draws equal ``jax.vmap(jax.random.categorical)``'s on
  seeded logits scaled by temperatures as ``sample_tokens`` scales them.
* ``ServeLoop``'s streams, greedy and stochastic, equal the reference
  ``ServeLoop``'s with the same seed: paged, unpaged, and a preempting
  pool whose evicted requests are restored (by replay) and go on
  sampling from the key after their n samples.
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

from repro.models import LMModel as JaxLMModel
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeLoop as JaxServeLoop
from repro.runtime.serve_loop import _advance_key
from repro_torch.configs.registry import get_serve_config
from repro_torch.convert import convert_params
from repro_torch.core import prng
from repro_torch.models import LMModel
from repro_torch.runtime import Request, ServeLoop
from tests._torch_port import jax_model_config
from tests.test_torch_serve import _serve, _trace

VOCAB = 152064
TINY = float(np.finfo(np.float32).tiny)


def _words(key):
    return tuple(int(x) for x in np.asarray(key))


def _keys(keys):
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(-2**31, 2**31 - 1), uid=st.integers(0, 2**32 - 1),
       num=st.integers(1, 6))
def test_key_fold_in_and_split_are_jaxs(seed, uid, num):
    base = jax.random.PRNGKey(seed)
    assert prng.prng_key(seed) == _words(base)
    folded = jax.random.fold_in(base, np.uint32(uid))
    assert prng.fold_in(prng.prng_key(seed), uid) == _words(folded)
    assert list(prng.split(_words(folded), num)) == [
        _words(k) for k in jax.random.split(folded, num)]
    kept, drawn = prng.split_keys(np.asarray([_words(folded)] * 2,
                                             np.int64))
    pair = jax.random.split(folded)
    assert [tuple(kept[0]), tuple(drawn[1])] == [_words(pair[0]),
                                                 _words(pair[1])]


@pytest.mark.parametrize("n", [0, 1, 7, 60])
def test_request_key_is_the_reference_replayed_key(n):
    base = jax.random.PRNGKey(11)
    want = _advance_key(jax.random.fold_in(base, 5), jnp.int32(n))
    assert prng.request_key(prng.prng_key(11), 5, n) == _words(want)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       shape=st.one_of(
           st.tuples(st.integers(1, VOCAB)),
           st.tuples(st.integers(1, 9), st.integers(1, 700)),
           st.tuples(st.integers(1, 3), st.integers(1, 5), st.integers(1, 40))))
def test_random_bits_are_jaxs(seed, shape):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.bits(key, shape)).astype(np.int64)
    got = prng.random_bits(_keys(key)[None], shape)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_bits_of_a_batch_of_keys_are_vmapped_jax():
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (4, 33)))(keys))
    got = prng.random_bits(_keys(keys), (4, 33))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (TINY, 1.0), (-2.0, 3.0)])
def test_uniform_is_jaxs_bit_for_bit(lo, hi):
    key = jax.random.PRNGKey(7)
    want = jax.random.uniform(key, (VOCAB,), jnp.float32, lo, hi)
    got = prng.uniform(_keys(key)[None], (VOCAB,), lo, hi)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_is_within_an_ulp_of_jaxs_at_each_log():
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (VOCAB,), minval=TINY))
    want_l = np.asarray(jnp.log(jnp.asarray(u)))
    got_l = torch.log(torch.from_numpy(u.copy())).numpy()
    assert np.all(np.abs(got_l - want_l) <= np.spacing(np.abs(want_l)))
    outer = np.asarray(jnp.log(jnp.asarray(-want_l)))
    got_outer = torch.log(torch.from_numpy(-want_l)).numpy()
    assert np.all(np.abs(got_outer - outer) <= np.spacing(np.abs(outer)))
    want = np.asarray(jax.random.gumbel(key, (VOCAB,)))
    got = prng.gumbel(_keys(key)[None], (VOCAB,))[0].numpy()
    carried = np.spacing(np.abs(want_l)) / np.abs(want_l)
    bound = 2 * np.spacing(np.abs(want)) + carried
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)
    assert np.mean(got == want) > 0.5


@pytest.mark.parametrize("vocab", [512, VOCAB])
def test_categorical_draws_are_jaxs(vocab):
    rng = np.random.default_rng(vocab)
    rows = 64 if vocab == 512 else 4
    logits = (rng.normal(size=(rows, vocab)) * 3).astype(np.float32)
    temps = rng.choice([0.5, 0.8, 1.0, 1.3], size=rows).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(vocab), rows)
    scaled = jnp.asarray(logits) / jnp.maximum(jnp.asarray(temps), 1e-6)[
        :, None]
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, scaled))
    got = prng.categorical(_keys(keys), torch.from_numpy(logits) / torch.clamp(
        torch.from_numpy(temps), min=1e-6)[:, None])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def models():
    cfg = get_serve_config("qwen3-14b", smoke=True)
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return cfg, jmodel, jparams, model, params


@pytest.mark.parametrize("pool", ["paged", "unpaged", "preempting"])
def test_stochastic_streams_equal_the_reference(models, pool):
    cfg, jmodel, jparams, model, params = models
    trace = _trace(cfg, n_req=6, seed=9, stochastic=True, max_new=12)
    kw = {"paged": {}, "unpaged": {"paged": False},
          "preempting": {"num_pages": 5}}[pool]
    common = dict(batch_slots=3, max_len=64, eos_token=cfg.vocab_size - 1,
                  prefill_chunk=8, **kw)
    ref_engine = JaxServeLoop(jmodel, jparams, rng=jax.random.PRNGKey(5),
                              **common)
    ref = _serve(ref_engine, trace, JaxRequest)
    engine = ServeLoop(model, params, device="cpu", seed=5, **common)
    out = _serve(engine, trace, Request)
    assert out == ref
    if pool == "preempting":
        assert engine.metrics.preemptions > 0
        assert ref_engine.metrics.preemptions > 0
    # the odd uids sampled: not their greedy continuations
    greedy = _serve(ServeLoop(model, params, device="cpu", seed=5, **common),
                    [dict(r, temperature=0.0) for r in trace], Request)
    assert any(out[u] != greedy[u] for u in out if u % 2)
    assert all(out[u] == greedy[u] for u in out if not u % 2)

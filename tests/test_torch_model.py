"""The port's ``LMModel.prefill`` / ``decode_step`` against the
reference's on the fp32 qwen3-14b serve-smoke config (impl pallas,
key/page blocks of 16, query block 16, chunks of 8 ⇒ G·C = 32 folded
rows, planes resident at any length), weights carried across by
``repro_torch.convert``.

Tolerance: logits at atol = rtol = 1e-4. Both sides compute the same
fp32 graph, but matmul, softmax and norm reductions sum in different
orders (XLA vs ATen), so logits of magnitude ~1–10 differ by ~1e-6
relative; selection is integer-exact on the same codes, so nothing
larger appears unless a quantized q code flips — which the tolerance
would expose."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import LMModel as JaxLMModel
from repro_torch.configs.registry import get_serve_config
from repro_torch.convert import convert_params
from repro_torch.models import LMModel
from tests._torch_port import jax_model_config, n, t

TOL = dict(atol=1e-4, rtol=1e-4)


def _models():
    cfg = get_serve_config("qwen3-14b", smoke=True)
    jmodel = JaxLMModel(jax_model_config(cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = LMModel(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, jparams), model)
    return cfg, jmodel, jparams, model, params


def test_prefill_and_decode_logits_match_reference():
    cfg, jmodel, jparams, model, params = _models()
    assert params["blocks"]["attn"]["wq"].shape == (
        cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim)
    max_len, chunk, num_pages = 64, 8, 8
    tables = np.array([[3, 0, 5, 1], [2, 7, 4, 6]], np.int32)
    jcache = jmodel.init_paged_cache(num_pages, max_len=max_len)
    cache = model.init_paged_cache(num_pages, max_len=max_len)
    assert "k_codes" in cache and set(cache) == set(jcache)
    rng = np.random.default_rng(0)
    lens = [24, 19]
    prompts = [rng.integers(1, cfg.vocab_size - 1, size=L) for L in lens]
    zero = np.zeros(2, np.int32)
    for c in range(3):
        toks = np.zeros((2, chunk), np.int32)
        pos = np.full((2, chunk), max_len, np.int32)   # sentinels
        for b, p in enumerate(prompts):
            part = p[c * chunk:(c + 1) * chunk]
            toks[b, :len(part)] = part
            pos[b, :len(part)] = c * chunk + np.arange(len(part))
        ref, jcache = jmodel.prefill(
            jparams, jcache, {"tokens": jnp.asarray(toks),
                              "positions": jnp.asarray(pos),
                              "block_table": jnp.asarray(tables)},
            jnp.asarray(zero))
        out, cache = model.prefill(
            params, cache, {"tokens": t(toks), "positions": t(pos),
                            "block_table": t(tables)}, t(zero))
        real = pos < max_len
        np.testing.assert_allclose(n(out)[real], n(ref)[real], **TOL)
    for key in ("k", "v", "k_scale"):
        np.testing.assert_allclose(n(cache[key]), n(jcache[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    # codes: a ±1 difference may appear where a value sits on a rounding
    # boundary after the fp32 projection, never more
    assert np.abs(n(cache["k_codes"]).astype(np.int32)
                  - np.asarray(jcache["k_codes"]).astype(np.int32)).max() <= 1

    idx = np.array(lens, np.int32)
    nxt = np.array([[5], [9]], np.int32)
    active = np.array([True, True])
    for step in range(3):
        if step == 2:
            active = np.array([True, False])        # an idle slot's write drops
        ref, jcache = jmodel.decode_step(
            jparams, jcache, {"tokens": jnp.asarray(nxt),
                              "active": jnp.asarray(active),
                              "block_table": jnp.asarray(tables)},
            jnp.asarray(idx))
        out, cache = model.decode_step(
            params, cache, {"tokens": t(nxt), "active": t(active),
                            "block_table": t(tables)}, t(idx))
        np.testing.assert_allclose(n(out)[active], n(ref)[active], **TOL)
        nxt = np.asarray(ref[:, -1].argmax(-1), np.int32)[:, None]
        idx = idx + active.astype(np.int32)
    np.testing.assert_allclose(n(cache["v"]), n(jcache["v"]), atol=1e-5,
                               rtol=1e-5)


def test_init_is_seeded_and_shaped():
    cfg = get_serve_config("qwen3-14b", smoke=True)
    model = LMModel(cfg, device="cpu")
    a, b = model.init(seed=3), model.init(seed=3)
    assert torch.equal(a["blocks"]["mlp"]["w_up"], b["blocks"]["mlp"]["w_up"])
    w = a["embed"]["table"]
    assert w.shape == (cfg.vocab_size, cfg.d_model)
    assert float(w.abs().max()) <= 2.0          # truncated at ±2·std
    assert abs(float(a["lm_head"]["w"].std()) * cfg.d_model ** 0.5
               - 0.88) < 0.05                   # std of N(0,1) cut at ±2

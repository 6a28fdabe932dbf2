"""The port's page pool against the reference's: the allocator (a copy)
must make the same placement decisions on the same operation sequence,
and the device helpers must move the same rows — into the contiguous
cache's layout, so that the paged and unpaged dense decode agree bit
for bit.

Last, the reference's allocator fuzzer (``tests/test_paged_cache.py``'s
hypothesis cases): random admit / grow / share / CoW / free
interleavings drive the port's allocator and the reference's in
lockstep, both audited after every op and equal in every decision; and
random overlapping-prefix traces through the port's paged-shared,
paged-unshared and unpaged engines give the same streams."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - optional dev dep
    from _hypothesis_fallback import given, settings, st

from repro.models import LMModel as JaxLMModel
from repro.runtime import paged_cache as jpgc
from repro_torch.configs.registry import get_serve_config
from repro_torch.models import LMModel
from repro_torch.runtime import paged_cache as tpgc
from tests._torch_port import dense_decode_twins, jax_model_config, n, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_decisions_match_reference(seed):
    """Random admit / grow / share / cow / register / free sequences."""
    rng = np.random.default_rng(seed)
    lay = dict(num_pages=12, page_size=4, max_blocks=6, batch_slots=3)
    ja = jpgc.PageAllocator(jpgc.PagedLayout(**lay))
    ta = tpgc.PageAllocator(tpgc.PagedLayout(**lay))
    prompts = [list(rng.integers(1, 5, size=16)) for _ in range(4)]
    for _ in range(120):
        op = rng.integers(0, 5)
        slot = int(rng.integers(0, 3))
        prompt = prompts[int(rng.integers(0, 4))]
        if op == 0:
            args = (slot, int(rng.integers(1, 24)))
            assert ja.ensure_capacity(*args) == ta.ensure_capacity(*args)
        elif op == 1:
            assert ja.match_prefix(prompt) == ta.match_prefix(prompt)
            for p in ja.match_prefix(prompt)[:2]:
                if ja.n_blocks[slot] < lay["max_blocks"]:
                    ja.share(slot, p)
                    ta.share(slot, p)
        elif op == 2 and ja.n_blocks[slot] > 0:
            blk = int(rng.integers(0, ja.n_blocks[slot]))
            assert ja.writable(slot, blk) == ta.writable(slot, blk)
            if not ja.writable(slot, blk):
                assert ja.cow(slot, blk) == ta.cow(slot, blk)
        elif op == 3:
            assert ja.register_prefix(slot, prompt) == \
                ta.register_prefix(slot, prompt)
        else:
            assert ja.free_slot(slot) == ta.free_slot(slot)
        np.testing.assert_array_equal(ja.block_tables, ta.block_tables)
        np.testing.assert_array_equal(ja.ref, ta.ref)
        assert ja.free_pages == ta.free_pages
        ta.check_invariants()


def test_device_helpers_match_reference():
    rng = np.random.default_rng(3)
    kv, pages, ps, d, mb = 2, 6, 4, 8, 3
    pool = rng.normal(size=(kv, pages * ps, d)).astype(np.float32)
    scales = rng.uniform(size=(kv, pages)).astype(np.float32)
    table = np.array([[5, 0, 2], [1, 3, 0]], np.int32)
    np.testing.assert_array_equal(
        n(tpgc.gather_logical_rows(t(pool), t(table), ps)),
        np.asarray(jpgc.gather_logical_rows(jnp.asarray(pool),
                                            jnp.asarray(table), ps)))
    np.testing.assert_array_equal(
        n(tpgc.gather_logical_scales(t(scales), t(table))),
        np.asarray(jpgc.gather_logical_scales(jnp.asarray(scales),
                                              jnp.asarray(table))))
    pos = np.array([[0, 5, 11, mb * ps], [3, 4, 7, 2]], np.int32)
    mask = np.array([True, False])
    ref = np.asarray(jpgc.paged_row_targets(
        jnp.asarray(pos), jnp.asarray(table), ps, jnp.asarray(mask)))
    out = n(tpgc.paged_row_targets(t(pos), t(table), ps, t(mask)))
    np.testing.assert_array_equal(out, ref)
    assert (out[1] == tpgc.DROP_ROW).all() and out[0, 3] == tpgc.DROP_ROW


def test_reset_and_clone_pages_match_reference():
    cfg = get_serve_config("qwen3-14b", smoke=True)
    jmodel = JaxLMModel(jax_model_config(cfg))
    model = LMModel(cfg, device="cpu")
    rng = np.random.default_rng(4)
    jcache = jmodel.init_paged_cache(6, max_len=32)
    jcache = {k: jnp.asarray(rng.normal(size=v.shape).astype(v.dtype))
              for k, v in jcache.items()}
    cache = {k: t(v) for k, v in jcache.items()}
    mask = np.array([False, True, False, False, True, False])
    jcache = jmodel.reset_pages(jcache, jnp.asarray(mask))
    model.reset_pages(cache, t(mask))
    jcache = jmodel.clone_pages(jcache, [0, 3], [1, 5])
    model.clone_pages(cache, [0, 3], [1, 5])
    for k in jcache:
        np.testing.assert_array_equal(n(cache[k]), np.asarray(jcache[k]),
                                      err_msg=k)
    assert tpgc.attention_cache_bytes(cache) == \
        jpgc.attention_cache_bytes(jcache)


def test_logical_rows_are_laid_out_as_the_contiguous_cache():
    """The paged view of the pool is a contiguous ``[B, KV, n, d]`` copy
    equal to the contiguous cache it spells, and the dense decode of the
    prefix layers gives the same bits on both layouts (a permuted view
    made cuBLAS sum in another order on the card: the two engines'
    streams could part)."""
    paged, unpaged, k_log, k = dense_decode_twins("cpu")
    assert k_log.is_contiguous() and torch.equal(k_log, k)
    assert torch.equal(paged, unpaged)


# --------------------------------------------------------------------------
# the allocator fuzzer (the reference's, on the port's allocator)
# --------------------------------------------------------------------------


def _lockstep(ops, **layout):
    """Replay ``ops`` through the reference's fuzz driver on its own
    allocator and on the port's, op by op: each driver asserts the
    allocator invariants after every op, and the two pools must agree."""
    from tests.test_paged_cache import _AllocatorFuzzDriver

    ref = _AllocatorFuzzDriver(**layout)
    port = _AllocatorFuzzDriver(**layout)
    lay = ref.a.layout
    port.a = tpgc.PageAllocator(tpgc.PagedLayout(
        num_pages=lay.num_pages, page_size=lay.page_size,
        max_blocks=lay.max_blocks, batch_slots=lay.batch_slots))
    for op in ops:
        ref.run([op])
        port.run([op])
        np.testing.assert_array_equal(port.a.block_tables,
                                      ref.a.block_tables)
        np.testing.assert_array_equal(port.a.ref, ref.a.ref)
        assert port.a.free_pages == ref.a.free_pages
        assert port.tokens == ref.tokens
    return port


_FUZZ_OPS = st.lists(
    st.tuples(
        st.integers(min_value=0, max_value=2),   # admit / grow / free
        st.integers(min_value=0, max_value=2),   # slot
        st.integers(min_value=0, max_value=2),   # shared-prefix family
        st.integers(min_value=1, max_value=20),  # length / growth
    ),
    max_size=80,
)


def test_fuzz_driver_example_in_lockstep():
    """The reference's fixed interleaving (attach, CoW, growth past
    shared pages, eviction under pressure, slot reuse), in every
    environment, hypothesis installed or not."""
    ops = [
        (0, 0, 0, 11), (0, 1, 0, 13), (1, 0, 0, 5), (2, 0, 0, 1),
        (0, 2, 0, 18), (1, 1, 0, 6), (0, 0, 1, 9), (2, 1, 0, 1),
        (0, 1, 1, 17), (1, 2, 0, 4), (2, 2, 0, 1), (0, 2, 2, 20),
        (0, 0, 0, 11), (1, 0, 0, 6), (2, 0, 0, 1), (0, 0, 0, 12),
    ]
    port = _lockstep(ops)
    assert any(tok is not None for tok in port.tokens)
    assert port.a.cached_pages + port.a.pages_in_use > 0


@settings(max_examples=120, deadline=None)
@given(ops=_FUZZ_OPS)
def test_random_interleavings_hold_invariants(ops):
    _lockstep(ops)


@settings(max_examples=60, deadline=None)
@given(ops=_FUZZ_OPS)
def test_random_interleavings_tiny_pool(ops):
    """The same under constant pool pressure (heavy eviction and
    exhaustion paths)."""
    _lockstep(ops, num_pages=5, max_blocks=5, slots=3)


_TRACE_STRATEGY = st.lists(
    st.tuples(
        st.integers(min_value=0, max_value=2),    # prefix family
        st.integers(min_value=0, max_value=14),   # suffix length
        st.integers(min_value=1, max_value=6),    # max_new_tokens
        st.booleans(),                            # stochastic?
    ),
    min_size=1, max_size=6,
)


@pytest.fixture(scope="module")
def fuzz_model():
    """The reference fuzz's model (3 layers, d 32, G 2, head dim 8, key
    and page blocks of 16, planes at any length) in the port."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import EnergonConfig

    cfg = ModelConfig(
        name="paged-test", family="dense", num_layers=3, d_model=32,
        num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
        dtype="float32", remat="none",
        energon=EnergonConfig(
            impl="mpmrf_block", pruning_ratio=2.0, query_block=8,
            key_block=16, decode_key_block=16, min_prune_layer=1,
            filter_cache_min_len=0,
        ),
    )
    model = LMModel(cfg, device="cpu")
    return cfg, model, model.init(seed=0)


def _drain_spec(spec, mode, fuzz_model):
    from repro_torch.runtime import Request, ServeLoop

    cfg, model, params = fuzz_model
    kw = dict(batch_slots=2, max_len=96, eos_token=cfg.vocab_size - 1,
              prefill_chunk=8, device="cpu")
    if mode == "unpaged":
        kw.update(paged=False)
    else:
        kw.update(paged=True, prefix_sharing=mode == "shared")
    engine = ServeLoop(model, params, **kw)
    for uid, (fam, extra, mnt, hot) in enumerate(spec):
        prefix = [(fam * 89 + j * 23) % 61 + 1 for j in range(24)]
        suffix = [(uid * 41 + j * 7) % 61 + 1 for j in range(extra)]
        engine.submit(Request(uid=uid, prompt=prefix + suffix,
                              max_new_tokens=mnt,
                              temperature=0.9 if hot else 0.0))
    done = engine.run_until_drained()
    assert len(done) == len(spec)
    return {r.uid: list(r.tokens_out) for r in done}


@settings(max_examples=5, deadline=None)
@given(spec=_TRACE_STRATEGY)
def test_differential_fuzz(fuzz_model, spec):
    """Paged-shared ≡ paged-unshared ≡ unpaged streams on random
    mixed-length overlapping-prefix traces, greedy and sampled."""
    shared = _drain_spec(spec, "shared", fuzz_model)
    assert shared == _drain_spec(spec, "unshared", fuzz_model)
    assert shared == _drain_spec(spec, "unpaged", fuzz_model)

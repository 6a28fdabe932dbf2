"""The port's page pool against the reference's: the allocator (a copy)
must make the same placement decisions on the same operation sequence,
and the device helpers must move the same rows — into the contiguous
cache's layout, so that the paged and unpaged dense decode agree bit
for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

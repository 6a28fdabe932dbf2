"""The CPU-visible half of the split decode gather (B2 / B6) and the
launch mirrors of the two redesigned gathers (B2 / B6, B4 / B8).

- The split rule (``decode_split_slots`` / ``decode_splits``: runs of 4
  consecutive survivor slots, longer where more than 32 splits would be
  needed; from the budget alone) and the workspace it sizes, at the
  serving path's shapes and at the edges; the shared memory the B4 / B8
  wrapper checks (the tile engine's, with the kept survivor lists).
- ``split_decode_gather_plain`` (here), the kernels' two-phase arithmetic
  (per-split partials, then a merge in split order), against the
  reference's ``paged_decode_gather_attention`` /
  ``decode_gather_attention`` (Pallas in interpret mode) on numpy inputs
  from a seed, at fp32 atol = rtol = 1e-5 (the same products summed in
  other orders; tighter than the bf16 gather tolerance the card is held
  to): budgets that are and are not multiples of the split, a split
  whose slots are all invalid, a row with no live key (0, not NaN) and
  cache lengths that cut inside a block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mpmrf_decode as jdec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mpmrf_decode as tdec
from tests._torch_port import n, t

TOL = dict(atol=1e-5, rtol=1e-5)
BH, G, D, BK, MB, PAGES = 4, 5, 16, 16, 8, 40


@pytest.mark.parametrize("budget, slots, splits", [
    (16, 4, 4),     # the serving path: 64 bh rows × 4 splits = 256 blocks
    (1, 4, 1), (4, 4, 1), (5, 4, 2), (8, 4, 2), (13, 4, 4), (64, 4, 16),
    (128, 4, 32),   # the most splits of 4 slots
    (129, 5, 26), (200, 7, 29), (1024, 32, 32),
    (0, 4, 1),      # an empty table still launches one (empty) split
])
def test_decode_split_rule(budget, slots, splits):
    assert tdec.decode_split_slots(budget) == slots
    assert tdec.decode_splits(budget) == splits
    assert splits <= tdec.DECODE_MAX_SPLITS
    # every slot lies in exactly one split, the last one possibly short
    covered = [s for sp in range(splits)
               for s in range(sp * slots, min((sp + 1) * slots, budget))]
    assert covered == list(range(budget))
    assert budget == 0 or (splits - 1) * slots < budget   # none empty


@pytest.mark.parametrize("bh, g, d, budget, floats", [
    (64, 5, 128, 16, 64 * 4 * 5 * 130),   # the serving path: 665.6 KB
    (1, 1, 8, 1, 1 * 1 * 1 * 10),
    (8, 16, 128, 13, 8 * 4 * 16 * 130),
])
def test_decode_workspace(bh, g, d, budget, floats):
    assert tdec.decode_workspace_floats(bh, g, d, budget) == floats


@pytest.mark.parametrize("d, bq, budget, smem", [
    # wgmma path: 64-row blocks, Q/O stage + 3 × (K, V) tiles of 64 keys,
    # then 2·budget kept ids, their count and the largest live position
    (128, 128, 16, 2 * 128 * (64 + 384) + 4 * 34),
    (64, 64, 8, 2 * 64 * (64 + 384) + 4 * 18),
    # mma.sync path: the whole query block in one block
    (128, 48, 16, 2 * 128 * (48 + 384) + 4 * 34),
    (16, 16, 1, 2 * 16 * (16 + 384) + 4 * 4),
])
def test_prefill_gather_smem_mirror(d, bq, budget, smem):
    assert fa.engine_smem_bytes(d, bq, 2 * budget + 1) == smem
    assert smem <= fa.SMEM_LIMIT


def _operands(rng, budget):
    q = rng.normal(size=(BH, G, D)).astype(np.float32)
    k = rng.normal(size=(PAGES, BK, D)).astype(np.float32)
    v = rng.normal(size=(PAGES, BK, D)).astype(np.float32)
    table = np.stack([rng.permutation(PAGES)[:MB] for _ in range(BH)])
    idx = rng.integers(0, MB, size=(BH, budget)).astype(np.int32)
    val = (rng.uniform(size=(BH, budget)) < 0.8).astype(np.int32)
    val[0] = 0                          # a row with no valid slot
    if budget > 4:
        val[1, 4:8] = 0                 # its second split: all invalid
    cl = np.array([60, 77, 5, 123], np.int32)  # cuts inside a block
    idx[2], val[2, 0] = 0, 1            # only 5 keys live, all in block 0
    return q, k, v, table.astype(np.int32), idx, val, cl


def split_decode_gather_plain(q, k_blocks, v_blocks, block_indices,
                              block_valid, cache_length, *, key_block):
    """The decode gather's two phases as the kernels (B2 / B6) run them,
    on the gathered survivor blocks ``[bh, S, bk, d]``: each split of
    ``decode_splits`` folds its run of slots into f32 partials (m, l
    and the unnormalised acc; m = NEG_INF, l = 0 where it keeps no live
    key), then the splits merge in split order with weights
    exp(m_i − M). f32 output."""
    bh, g, d = q.shape
    bk = key_block
    sm_scale = 1.0 / (d ** 0.5)
    kpos = block_indices.long()[..., None] * bk + torch.arange(
        bk, device=q.device)                                  # [bh, S, bk]
    ok = (block_valid[..., None] > 0) & (
        kpos < cache_length.long()[:, None, None])
    s = torch.einsum("bgd,bskd->bgsk", q.float(),
                     k_blocks.float()) * sm_scale
    s = torch.where(ok[:, None], s, tdec.NEG_INF)             # [bh,g,S,bk]
    parts = []
    budget = block_indices.shape[-1]
    slots = tdec.decode_split_slots(budget)
    for sp in range(tdec.decode_splits(budget)):
        run = slice(sp * slots, (sp + 1) * slots)
        sc = s[:, :, run].reshape(bh, g, -1)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.where(sc <= tdec.NEG_INF / 2, 0.0, torch.exp(sc - m))
        acc = torch.matmul(p, v_blocks[:, run].float().reshape(bh, -1, d))
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
    big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(big)
    acc = torch.zeros((bh, g, d), dtype=torch.float32, device=q.device)
    for m, pl, pa in parts:
        w = torch.exp(m - big)
        l = l + w * pl
        acc = acc + w * pa
    return acc / torch.clamp(l, min=1e-30)


def _split_plain_paged(q, k, v, table, idx, val, cl):
    pages = torch.gather(t(table).long(), 1, t(idx).long())
    return split_decode_gather_plain(
        t(q), t(k)[pages], t(v)[pages], t(idx), t(val), t(cl),
        key_block=BK)


@pytest.mark.parametrize("budget", [3, 4, 7, 8, 13, 133])
def test_split_decode_gather_matches_pallas_paged(budget):
    rng = np.random.default_rng(budget)
    q, k, v, table, idx, val, cl = _operands(rng, budget)
    ref = jdec.paged_decode_gather_attention(
        *(jnp.asarray(x) for x in (q, k, v, idx, val, table, cl)),
        key_block=BK, interpret=True)
    out = _split_plain_paged(q, k, v, table, idx, val, cl)
    np.testing.assert_allclose(n(out), n(ref), **TOL)
    assert np.isfinite(n(out)).all()
    assert not n(out)[0].any()          # no live key: 0, not NaN


@pytest.mark.parametrize("budget", [6, 9])
def test_split_decode_gather_matches_pallas_contiguous(budget):
    rng = np.random.default_rng(10 + budget)
    q, _, _, _, idx, val, cl = _operands(rng, budget)
    n_k = MB * BK
    k = rng.normal(size=(BH, n_k, D)).astype(np.float32)
    v = rng.normal(size=(BH, n_k, D)).astype(np.float32)
    cl[3] = n_k + 1                     # an idle slot's max_len + 1 length
    ref = jdec.decode_gather_attention(
        *(jnp.asarray(x) for x in (q, k, v, idx, val, cl)), key_block=BK,
        interpret=True)
    rows = torch.arange(BH)[:, None]
    blocks = lambda x: t(x).reshape(BH, MB, BK, D)[rows, t(idx).long()]
    out = split_decode_gather_plain(
        t(q), blocks(k), blocks(v), t(idx), t(val), t(cl), key_block=BK)
    np.testing.assert_allclose(n(out), n(ref), **TOL)
    assert not n(out)[0].any()


def test_split_merge_weighs_an_empty_split_zero():
    """A split that keeps nothing (m = NEG_INF, l = 0) leaves the other
    splits' result unchanged, bit for bit; a row whose every split is
    empty comes out 0."""
    rng = np.random.default_rng(3)
    q, k, v, table, idx, val, cl = _operands(rng, 4)
    base = _split_plain_paged(q, k, v, table, idx, val, cl)
    # four more slots, all invalid: a second, empty split
    idx8 = np.concatenate([idx, idx], axis=1)
    val8 = np.concatenate([val, np.zeros_like(val)], axis=1)
    assert tdec.decode_splits(8) == 2
    out = _split_plain_paged(q, k, v, table, idx8, val8, cl)
    assert torch.equal(out, base)
    none = _split_plain_paged(q, k, v, table, idx8, np.zeros_like(val8), cl)
    assert torch.equal(none, torch.zeros_like(none))

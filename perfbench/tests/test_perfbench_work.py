"""The frozen work counts against shapes computed by hand."""

import _perfbench_paths  # noqa: F401
import pytest

from perfbench.harness import bench
from perfbench.work import kernels as K
from perfbench.work import model as M
from perfbench.work.peaks import HBM_BYTES_S, PEAK_BF16, PEAK_INT8

QWEN = bench.load_json(bench.HERE / "configs" / "qwen3-14b.json")
OLMOE = bench.load_json(bench.HERE / "configs" / "olmoe-1b-7b.json")


def test_decode_survivors():
    # 1000 rows: 16 live blocks, budget ceil(16 / 4) = 4; the newest
    # block holds 1000 − 960 = 40 rows
    assert K.decode_survivors(1000, 64, 4.0) == (4, 3 * 64 + 40)
    # one block: one pin, its rows
    assert K.decode_survivors(10, 64, 4.0) == (1, 10)
    # two blocks: budget 1, two pins
    assert K.decode_survivors(100, 64, 4.0) == (2, 64 + 36)


def test_decode_filter_and_gather_by_hand():
    b, o, peak = K.decode_filter([1000], kv=8, g=5, d=128, bk=64)
    live = 16
    want = (8 * 5 * 128 * 4 + 8 * 5 * 4 + 4 + live * 4
            + 8 * 1000 * 128 * 2 + 8 * live * 4 + 2 * 8 * live * 4)
    assert (b, o, peak) == (want, 8 * 1000 * 5 * 128 * 4, PEAK_INT8)
    b, o, peak = K.decode_gather([1000], kv=8, g=5, d=128, bk=64, rho=4.0)
    rows = 3 * 64 + 40
    assert b == 2 * 8 * 5 * 128 * 2 + 8 * 4 * 4 + 8 * rows * 128 * 2 * 2
    assert (o, peak) == (8 * rows * 5 * 128 * 4, PEAK_BF16)


def test_prefill_filter_by_hand():
    b, o, peak = K.prefill_filter([(512, 640)], kv=8, g=5, d=128, bq=128,
                                  bk=64, chunk=128)
    rows = 128 * 5 * 8
    pairs = sum(p + 1 for p in range(512, 640)) * 5 * 8
    seen = 10
    want = (rows * (128 * 4 + 4 + 4) + seen * 4 + 8 * 640 * 128 * 2
            + 8 * seen * 4 + 2 * 5 * 8 * seen * 4)
    assert (b, o, peak) == (want, pairs * 128 * 4, PEAK_INT8)


def test_sequence_kernels_by_hand():
    b, o, _ = K.sequence_filter(3, 40, 8, 8192, 128, 128, 64)
    n_qb = 64
    tiles = 2 * n_qb * (n_qb + 1) // 2
    assert b == (120 * 8192 * 132 + 2 * 24 * 8192 * 128
                 + 2 * 120 * tiles * 4)
    assert o == 120 * (8192 * 8193 // 2) * 128 * 4
    b, o, _ = K.flash(3, 40, 8, 8192, 128)
    assert b == (240 + 48) * 8192 * 128 * 2
    assert K.bound_s((HBM_BYTES_S, 0, PEAK_BF16)) == 1.0
    assert K.bound_s((0, PEAK_BF16 * 2, PEAK_BF16)) == 2.0


def test_model_counts_by_hand():
    used, total = M.layer_params(QWEN)
    attn = 5120 * (40 + 16) * 128 + 40 * 128 * 5120
    assert used == total == attn + 3 * 5120 * 17408
    # 29.6 GB in bf16 with the embedding table, of which a step reads
    # only the rows of its tokens
    assert M.weight_bytes(QWEN) == 2 * (40 * used + 5120 * 151936)
    assert 29.4e9 < M.weight_bytes(QWEN) + 2 * 151936 * 5120 < 29.7e9
    used, total = M.layer_params(OLMOE)
    attn = 2048 * 48 * 128 + 16 * 128 * 2048
    assert used == attn + 2048 * 64 + 8 * 3 * 2048 * 1024
    assert total == attn + 2048 * 64 + 64 * 3 * 2048 * 1024
    f = M.score_flops(QWEN, 3, 8192)
    assert f == pytest.approx(2 * 3 * 8192 * (40 * M.layer_params(QWEN)[0]
                                              + 5120 * 151936)
                              + 2 * 3 * 40 * (8192 * 8193 // 2) * 128 * 4)


def test_step_bounds_are_lower_bounds_of_their_parts():
    f, i8, b = M.decode_step(QWEN, [1000, 2000])
    assert b > M.weight_bytes(QWEN)
    assert M.step_bound_s(f, i8, b) == pytest.approx(b / HBM_BYTES_S)
    f, i8, b = M.prefill_wave(QWEN, [(512, 640)], finishing=0, chunk=128)
    assert b < M.weight_bytes(QWEN) + 1e9


def test_block_pairs_and_live_budget_by_hand():
    # rows 128 .. 255 see blocks 0 and 1 whole; block 2 (keys 128 .. 191)
    # Σ min(64, p − 127) = 2080 + 64 · 64; block 3 Σ (p − 191) = 2080
    assert K.block_pairs(range(128, 256), 64) == [8192, 8192, 6176, 2080]
    # four live blocks: budget ceil(4 / 4) = 1, the one with fewest pairs
    assert K.budget_pairs(range(128, 256), 64, 4.0) == (1, 2080)
    assert K.live_budget(5, 4.0) == 2 and K.live_budget(1, 4.0) == 1


def test_sequence_sparse_by_hand():
    # each of the two query blocks has two live blocks, budget 1: the
    # diagonal's upper half, 1 + … + 64 = 2080 pairs
    b, o, peak = K.sequence_sparse(1, 2, 1, 256, 8, 128, 64, 4.0)
    assert b == 2 * 2 * 256 * 8 * 2 + 2 * 2 * 2 * 4 + 1 * 64 * 8 * 2 * 2
    assert (o, peak) == (2 * 2 * 2080 * 8 * 4, PEAK_BF16)


def test_prefill_gather_by_hand():
    # a 100-row chunk of 2 folded heads: each head's query block sees
    # positions 0 .. 99, blocks 0 (2080 + 36 · 64 pairs) and 1 (1 + … +
    # 36 = 666); budget 1 takes block 1
    b, o, peak = K.prefill_gather([(0, 100)], kv=1, g=2, d=8, bq=128,
                                  bk=64, chunk=128, rho=4.0)
    assert b == 200 * (2 * 8 * 2 + 4) + 2 * 2 * 4 + 64 * 8 * 2 * 2
    assert (o, peak) == (2 * 666 * 8 * 4, PEAK_BF16)


def test_gathers_at_the_budget_do_less_than_whole_attention():
    b, o, _ = K.sequence_sparse(3, 40, 8, 8192, 128, 128, 64, 4.0)
    _, whole, _ = K.flash(3, 40, 8, 8192, 128)
    assert 0.2 * whole < o < 0.3 * whole

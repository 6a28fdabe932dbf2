"""The CUDA kernels against their plain versions on the card (B1–B11),
and the contiguous twins B5–B8 against the paged B1–B4 on the same rows;
the split decode gather (B2 / B6) and the tile-engine prefill gather
(B4 / B8) across their instantiations, edge rows and tables, twice.
Every kernel's grid holds head dim 96 (phi3-mini's, run on the d-128
instantiation with zero-filled columns) beside 16, 32, 64 and 128, and
80 and 112 at one shape each; phi3-mini at full width (3 layers) serves
on B1–B4 with the plain versions' first tokens.

Marked ``gpu``: on a host without CUDA every case skips. On the GPU
machine run ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_cuda.py`` (``--noconftest``: the suite's conftest
imports ``jax``). ``python3 chip_smoke.py`` makes the same checks at the
serving shapes.
Filter scores must be bit-equal; bf16 gathers agree within
``repro_torch.kernels.gather_within_tolerance`` (both sides compute in
f32 and round the output once: at most one bf16 ulp apart).

Last, the serve steps replayed from CUDA graphs against the eager steps
on the serve-smoke model in bf16, bit for bit: greedy and sampled
streams, the final cache and the kernels' launch counts of whole drains
(both layouts, both schedulers, prefix sharing with copy-on-write, a
pool small enough to preempt), a decode replay after the block table
gained a page and after the capture stream's gather scratch was
outgrown, the cache across a capture, engines capturing on one stream
and giving back their graphs' memory, and the refusal of inputs that do
not say which rows are live; the telemetry variants (graphed ≡ eager
counts, the plain steps' streams and launches) and a chaos drain
(graphed ≡ eager outcomes and event trace).

Serving over a mesh of the one card (``cuda:0`` × M): a lone engine on
``(1, 2)`` and ``(1, 4)`` meshes, graphed ≡ eager ≡ the single-device
engine (streams, the pool's rows across its shards, B1–B4 launched once
per shard), and a ``(2, 2)`` replicated drain ≡ the single engine.

The MoE layer at olmoe-1b-7b's widths (64 experts top-8): replayed from
a CUDA graph ≡ eager, bit for bit, at the decode step's and the prefill
wave's shapes, and the same bits on three replays; olmoe's smoke model's
prefill and decode step on the card against the CPU.

Expert parallelism (``cuda:0`` × M): an MoE engine's graphed drain ≡
its eager drain on ``(1, 2)`` and ``(1, 4)``; olmoe's layer on a ``(1,
4)`` mesh against the port's expert-parallel layer on ``cpu`` × 4 in
f32; and B1–B4 at qwen3-moe-235b-a22b's G 16 (decode bh 32; prefill
chunks of 64, 1024 folded rows) against their plain versions.

Training: one train step of a narrow model on the card against the
same step on the CPU, and the ``pallas`` loss refused under grad on the
card as on the CPU."""

import dataclasses
import gc
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import gather_within_tolerance
# by its own name, from this directory (pytest puts it on the path): on
# the GPU machine ``tests`` can name another installed package
from _torch_port import chunked_tables, dense_decode_twins

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(cuda, bh=6, g=4, d=64, bk=16, mb=8, n_q=64, bq=32, seed=0):
    from repro_torch.core import quantization as qlib

    gen = torch.Generator(device=cuda).manual_seed(seed)
    pages = bh * mb
    k = torch.randn((pages * bk, d), generator=gen, device=cuda)
    codes, scale = qlib.quantize_int16_blocks(k, bk)
    table = torch.randperm(pages, generator=gen, device=cuda).reshape(bh, mb)
    return dict(
        q_dec=torch.randn((bh, g, d), generator=gen, device=cuda),
        q_pre=torch.randn((bh, n_q, d), generator=gen, device=cuda),
        k=k.to(torch.bfloat16).reshape(pages, bk, d),
        v=torch.randn((pages, bk, d), generator=gen, device=cuda).to(
            torch.bfloat16),
        codes=codes.reshape(pages, bk, d), scale=scale.reshape(pages, 1),
        table=table.to(torch.int32),
        cl=torch.randint(1, mb * bk + 1, (bh,), generator=gen, device=cuda
                         ).to(torch.int32),
        qpos=(torch.randint(0, mb * bk - n_q, (bh, 1), generator=gen,
                            device=cuda) + torch.arange(n_q, device=cuda)
              ).to(torch.int32),
        bk=bk, bq=bq,
    )


def _planes(q):
    from repro_torch.core import quantization as qlib

    q16 = qlib.quantize_int16(q, axis=-1)
    return q16.bit_plane(4).contiguous(), q16.scale.contiguous()


def test_decode_kernels_match_plain(cuda):
    from repro_torch.kernels import mpmrf_decode as dk

    c = _case(cuda)
    qp, qs = _planes(c["q_dec"])
    args = (qp, qs, c["codes"], c["scale"], c["table"], c["cl"])
    s = dk.paged_filter_scores(*args, key_block=c["bk"])
    r = dk.paged_filter_scores_plain(*args, key_block=c["bk"])
    assert torch.equal(s[0], r[0]) and torch.equal(s[1], r[1])
    idx = torch.argsort(-s[1], dim=-1, stable=True)[:, :3].to(torch.int32)
    val = (torch.gather(s[1], 1, idx.long()) > -5e29).to(torch.int32)
    q = c["q_dec"].to(torch.bfloat16)
    gargs = (q, c["k"], c["v"], idx, val, c["table"], c["cl"])
    out = dk.paged_decode_gather_attention(*gargs, key_block=c["bk"]).float()
    ref = dk.paged_decode_gather_attention_plain(
        *gargs, key_block=c["bk"]).float()
    assert gather_within_tolerance(out, ref)


def test_prefill_kernels_match_plain(cuda):
    from repro_torch.kernels import mpmrf_prefill as pk

    c = _case(cuda, seed=1)
    qp, qs = _planes(c["q_pre"])
    args = (qp, qs, c["qpos"], c["codes"], c["scale"], c["table"])
    kw = dict(query_block=c["bq"], key_block=c["bk"])
    s = pk.paged_prefill_filter_scores(*args, **kw)
    r = pk.paged_prefill_filter_scores_plain(*args, **kw)
    assert torch.equal(s[0], r[0]) and torch.equal(s[1], r[1])
    idx = torch.argsort(-s[1], dim=-1, stable=True)[..., :3].to(torch.int32)
    val = (torch.gather(s[1], 2, idx.long()) > -5e29).to(torch.int32)
    q = c["q_pre"].to(torch.bfloat16)
    gargs = (q, c["qpos"], c["k"], c["v"], idx, val, c["table"])
    out = pk.paged_prefill_gather_attention(*gargs, **kw).float()
    ref = pk.paged_prefill_gather_attention_plain(*gargs, **kw).float()
    assert gather_within_tolerance(out, ref)


def _planes_full_sequence(cuda, bh, n, d, seed):
    """Int8 planes of the full-sequence filter (B9) in their value
    ranges: q 4-bit, k MSB 2-bit, remainder 2-bit unsigned."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randint(-8, 8, (bh, n, d), generator=gen, device=cuda)
    msb = torch.randint(-2, 2, (bh, n, d), generator=gen, device=cuda)
    rem = torch.randint(0, 4, (bh, n, d), generator=gen, device=cuda)
    qs = torch.rand((bh, n, 1), generator=gen, device=cuda) * 1e-3 + 1e-5
    return (q.to(torch.int8), msb.to(torch.int8), rem.to(torch.int8), qs)


#: (d, query block, key block) of the filter engine (B3 / B7 / B9): its
#: wgmma path (d 128, query blocks of one or two warpgroups, key blocks
#: of one or two 64-key products) and its mma.sync path at every head dim
#: (d 16 on m16n8k16, the rest on m16n8k32), query blocks of one to eight
#: warps (16–128 rows), key blocks of half a 16-key group (8), of one
#: and a half (24), of one (16), of four (64) and of eight (128)
FILTER_SHAPES = [(16, 16, 16), (32, 48, 64), (64, 64, 128), (128, 128, 64),
                 (128, 16, 128), (64, 128, 16), (32, 64, 64),
                 (128, 128, 128), (128, 64, 64), (128, 128, 16),
                 (16, 16, 8), (64, 32, 24),
                 # head dims padded to an instantiation: d 96 on both
                 # paths, 80 / 112 on wgmma / mma.sync, 48 padded to 64
                 (96, 128, 64), (96, 32, 16), (80, 128, 64), (112, 48, 24),
                 (48, 64, 64)]


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 48),
                                             (True, 301), (False, 0)])
@pytest.mark.parametrize("d,bq,bk", FILTER_SHAPES)
def test_filter_kernel_matches_plain(cuda, d, bq, bk, causal, q_offset):
    """B9 = its plain version bit for bit, at causal offsets 0 and not
    aligned to a block, and without the mask; row 0 at the extreme plane
    values (q −8, msb −2, rem 3: the largest |acc|), a negative and a
    zero q scale (the per-pair rescale); the same when run twice. With 6
    rows of few query blocks the launch splits each query block's keys
    into runs, so visible ranges end inside and across runs."""
    from repro_torch.kernels import mpmrf_filter as fk

    q, msb, rem, qs = _planes_full_sequence(cuda, 6, 384, d, seed=2)
    q[0], msb[0], rem[0] = -8, -2, 3
    qs[1, 5], qs[2, 7] = -qs[1, 5], 0.0
    kw = dict(query_block=bq, key_block=bk, shift=2, causal=causal,
              q_offset=q_offset)
    out = fk.mpmrf_filter_scores(q, msb, rem, qs, **kw)
    ref = fk.mpmrf_filter_scores_plain(q, msb, rem, qs, **kw)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    again = fk.mpmrf_filter_scores(q, msb, rem, qs, **kw)
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])


#: (d, query block, key block, round bits) of B3 / B7 on the engine: its
#: shapes, plus the widest planes it derives (msb 1 bit and hi 8 bits: the
#: packed shifts by 7 and by 0), a (3, 7) split, and lo = 0 (the msb
#: plane the code's sign: the shift by 7 again)
PREFILL_FILTER_SHAPES = [(16, 16, 16, (2, 4)), (32, 48, 64, (2, 4)),
                         (64, 64, 128, (2, 4)), (128, 128, 64, (2, 4)),
                         (128, 128, 128, (2, 4)), (128, 16, 64, (2, 4)),
                         (64, 128, 16, (3, 7)), (128, 128, 64, (1, 8)),
                         (128, 64, 128, (2, 4)), (128, 48, 16, (2, 4)),
                         (32, 16, 8, (2, 4)), (128, 64, 24, (2, 4)),
                         (128, 128, 64, (0, 8)), (64, 32, 16, (0, 8)),
                         (96, 128, 64, (2, 4)), (96, 32, 16, (0, 8)),
                         (80, 128, 64, (2, 4)), (112, 64, 24, (1, 8))]


@pytest.mark.parametrize("d,bq,bk,round_bits", PREFILL_FILTER_SHAPES)
def test_prefill_filters_match_plain_and_each_other(cuda, d, bq, bk,
                                                    round_bits):
    """B7 = its plain version bit for bit, B3 = B7 on the same rows laid
    out as pages, both the same when run twice, and B7 with a key tile of
    two scale groups = its plain version. Folded chunks of C = bq/2 rows
    under 4 heads; row 0's chunk starts at position 0, row 1 ends in
    sentinel rows, row 3 is all sentinels (every score NEG_INF); row 2 at
    the extreme planes (q and every code at their most negative: the
    largest |acc|); one row with a negative q scale (the per-pair
    rescale)."""
    from repro_torch.kernels import mpmrf_prefill as pk

    lo, hi = round_bits
    bh, n_kb, heads = 4, 10, 4
    chunk = bq // 2
    gen = torch.Generator(device=cuda).manual_seed(d + bq + bk + hi)
    n_k, n_q = n_kb * bk, heads * chunk
    codes = torch.randint(-32768, 32768, (bh, n_k, d), generator=gen,
                          device=cuda, dtype=torch.int32).to(torch.int16)
    codes[2] = -32768
    scale = torch.rand((bh, n_kb), generator=gen, device=cuda) + 0.05
    row_scale = scale.repeat_interleave(bk, dim=-1).contiguous()
    half = 1 << (hi - 1)
    q = torch.randint(-half, half, (bh, n_q, d), generator=gen, device=cuda,
                      dtype=torch.int32)
    q[2] = -half
    qs = torch.rand((bh, n_q, 1), generator=gen, device=cuda) * 1e-3 + 1e-5
    qs[0, 3] = -qs[0, 3]
    off = torch.randint(0, n_k - chunk + 1, (bh, 1), generator=gen,
                        device=cuda)
    off[0] = 0
    pos = off + torch.arange(chunk, device=cuda)
    pos[1, -5:] = n_k
    pos[3] = n_k
    qpos = pos.repeat(1, heads).to(torch.int32)
    kw = dict(round_bits=round_bits, query_block=bq, key_block=bk)
    args = (q, qs, qpos, codes, row_scale)
    out = pk.mpmrf_prefill_filter_scores(*args, **kw)
    ref = pk.mpmrf_prefill_filter_scores_plain(*args, **kw)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert (out[0][3] == pk.NEG_INF).all() and (out[1][3] == pk.NEG_INF).all()
    again = pk.mpmrf_prefill_filter_scores(*args, **kw)
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])
    table = torch.randperm(bh * n_kb, generator=gen, device=cuda)
    inv = torch.empty_like(table)
    inv[table] = torch.arange(bh * n_kb, device=cuda)
    pages = codes.reshape(bh * n_kb, bk, d)[inv].contiguous()
    page_scale = scale.reshape(-1)[inv].reshape(-1, 1).contiguous()
    table = table.reshape(bh, n_kb).to(torch.int32)
    paged = pk.paged_prefill_filter_scores(q, qs, qpos, pages, page_scale,
                                           table, **kw)
    assert torch.equal(paged[0], out[0]) and torch.equal(paged[1], out[1])
    if 2 * bk <= 128:            # a key tile across two scale groups
        wide = dict(kw, key_block=2 * bk)
        s2 = pk.mpmrf_prefill_filter_scores(*args, **wide)
        r2 = pk.mpmrf_prefill_filter_scores_plain(*args, **wide)
        assert torch.equal(s2[0], r2[0]) and torch.equal(s2[1], r2[1])


def _qkv(cuda, bh, n, d, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(3)]


#: every instantiation and tiling of the B10/B11 tile engine: d ∈ {16,
#: 32, 64, 128}, one to eight warps, a key block of 8 (one ring tile
#: padded with masked keys), of 16, of one ring tile (64) and of two
#: (128); d 96 on the wgmma and the mma.sync path, 80 and 112
ENGINE_SHAPES = [(16, 16, 8), (32, 32, 16), (64, 64, 64), (128, 128, 64),
                 (128, 128, 128), (96, 128, 64), (96, 32, 16),
                 (80, 64, 64), (112, 128, 128)]
EARLY_ROWS = 32   # where two or three keys carry a row: bf16 P fails here


def _assert_attention_close(out, ref):
    """Within the gather tolerance overall, and on the first 32 query
    rows of each bh row on their own."""
    out, ref = out.float(), ref.float()
    assert gather_within_tolerance(out, ref)
    assert gather_within_tolerance(out[:, :EARLY_ROWS], ref[:, :EARLY_ROWS])


@pytest.mark.parametrize("q_offset", [0, 64])
@pytest.mark.parametrize("d,bq,bk", ENGINE_SHAPES)
def test_attention_kernels_match_plain(cuda, d, bq, bk, q_offset):
    """Causal B10 (the filter's selection) and B11 against their plain
    versions; at q_offset 64 the 256 queries sit over 384 keys (n_q <
    n_k). With every causal block a survivor, B10 is dense: ≈ B11."""
    from repro_torch.kernels import block_sparse_attention as bsa
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    n_q, bh = 256, 6
    n_k = n_q + 2 * q_offset
    q, k, v = _qkv(cuda, bh, n_k, d, seed=3)
    q = q[:, :n_q].contiguous()
    kw = dict(query_block=bq, key_block=bk, causal=True, q_offset=q_offset)
    idx, val = ops.mpmrf_select_blocks(q, k, block_budget=2, **kw)
    out = bsa.block_sparse_attention(q, k, v, idx, val, **kw)
    ref = bsa.block_sparse_attention_plain(q, k, v, idx, val, **kw)
    _assert_attention_close(out, ref)
    fkw = dict(causal=True, q_offset=q_offset, block_q=bq, block_k=bk)
    dense = fa.flash_attention(q, k, v, **fkw)
    dref = fa.flash_attention_plain(q, k, v, causal=True, q_offset=q_offset)
    _assert_attention_close(dense, dref)
    # every key block a survivor (ρ ≤ 1): the sparse kernel is dense
    n_qb, n_kb = n_q // bq, n_k // bk
    all_idx = torch.arange(n_kb, device=cuda, dtype=torch.int32).expand(
        bh, n_qb, n_kb).contiguous()
    all_val = torch.ones_like(all_idx)
    full = bsa.block_sparse_attention(q, k, v, all_idx, all_val, **kw)
    _assert_attention_close(full, dref)


@pytest.mark.parametrize("d,bq,bk", ENGINE_SHAPES)
def test_attention_kernels_match_plain_noncausal(cuda, d, bq, bk):
    """Non-causal B11 and B10 with 128 queries over 256 keys."""
    from repro_torch.kernels import block_sparse_attention as bsa
    from repro_torch.kernels import flash_attention as fa

    n_q, n_k, bh = 128, 256, 4
    q, k, v = _qkv(cuda, bh, n_k, d, seed=7)
    q = q[:, :n_q].contiguous()
    dense = fa.flash_attention(q, k, v, causal=False, block_q=bq, block_k=bk)
    _assert_attention_close(dense, fa.flash_attention_plain(
        q, k, v, causal=False))
    n_qb, n_kb = n_q // bq, n_k // bk
    gen = torch.Generator(device=cuda).manual_seed(8)
    idx = torch.randint(0, n_kb, (bh, n_qb, 3), generator=gen, device=cuda,
                        dtype=torch.int32)
    val = torch.ones_like(idx)
    kw = dict(query_block=bq, key_block=bk, causal=False)
    _assert_attention_close(
        bsa.block_sparse_attention(q, k, v, idx, val, **kw),
        bsa.block_sparse_attention_plain(q, k, v, idx, val, **kw))


@pytest.mark.parametrize("d,bq,bk", ENGINE_SHAPES)
def test_block_sparse_table_with_invalid_and_masked_slots(cuda, d, bq, bk):
    """A hand-made survivor table: random ids, some slots invalid (one
    query block with none valid: its rows come out 0), and survivors
    wholly above the diagonal, which the kernel skips unread."""
    from repro_torch.kernels import block_sparse_attention as bsa

    n, bh, budget = 256, 4, 4
    q, k, v = _qkv(cuda, bh, n, d, seed=9)
    n_qb, n_kb = n // bq, n // bk
    gen = torch.Generator(device=cuda).manual_seed(10)
    idx = torch.randint(0, n_kb, (bh, n_qb, budget), generator=gen,
                        device=cuda, dtype=torch.int32)
    val = (torch.rand((bh, n_qb, budget), generator=gen, device=cuda)
           < 0.7).to(torch.int32)
    idx[:, 0, 0], val[:, 0, 0] = n_kb - 1, 1      # above the diagonal
    idx[:, 0, 1], val[:, 0, 1] = 0, 1             # the first block
    val[0, -1] = 0                                # no valid slot at all
    kw = dict(query_block=bq, key_block=bk, causal=True)
    out = bsa.block_sparse_attention(q, k, v, idx, val, **kw)
    _assert_attention_close(out, bsa.block_sparse_attention_plain(
        q, k, v, idx, val, **kw))
    assert not out[0, -bq:].any()


def test_energon_block_attention_grad(cuda):
    from repro_torch.kernels import block_sparse_attention as bsa
    from repro_torch.kernels import ops

    q, k, v = (x.requires_grad_() for x in _qkv(cuda, 4, 128, 16, seed=4))
    kw = dict(query_block=16, key_block=16)
    out = ops.energon_block_attention(q, k, v, 3, 16, 16, True)
    idx, val = ops.mpmrf_select_blocks(q.detach(), k.detach(),
                                       block_budget=3, **kw)
    want = ops.block_sparse_attention(q.detach(), k.detach(), v.detach(),
                                      idx, val, **kw)
    assert torch.equal(out.detach(), want)
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), g)
    ref = torch.autograd.grad(
        bsa.block_sparse_attention_plain(q, k, v, idx, val, **kw), (q, k, v),
        g)
    # the same plain graph twice; its index backward accumulates with
    # atomics, so the bf16 grads may differ in the order of their sums
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b)


def _contiguous_case(cuda, d, bk, bh=6, g=4, n_kb=8, n_q=64, seed=5):
    """A contiguous cache ``[bh, n_k, d]`` and the same rows laid out as
    pages under a shuffled table (B1–B4's operands)."""
    from repro_torch.core import quantization as qlib

    gen = torch.Generator(device=cuda).manual_seed(seed)
    n_k = n_kb * bk
    k = torch.randn((bh, n_k, d), generator=gen, device=cuda)
    codes, scale = qlib.quantize_int16_blocks(k, bk)      # [bh, n_kb]
    v = torch.randn((bh, n_k, d), generator=gen, device=cuda)
    table = torch.randperm(bh * n_kb, generator=gen, device=cuda).reshape(
        bh, n_kb)
    inv = torch.empty_like(table.reshape(-1))
    inv[table.reshape(-1)] = torch.arange(bh * n_kb, device=cuda)

    def pages(x):                          # [bh, n_k, ...] → [P, bk, ...]
        return x.reshape(bh * n_kb, bk, *x.shape[2:])[inv].contiguous()

    cl = torch.randint(1, n_k + 1, (bh,), generator=gen, device=cuda)
    cl[0] = n_k + 1                        # an idle slot's sentinel length
    qpos = (torch.randint(0, n_k - n_q, (bh, 1), generator=gen, device=cuda)
            + torch.arange(n_q, device=cuda))
    qpos[1, -7:] = n_k                     # ragged tail: sentinel rows
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    return dict(
        q_dec=torch.randn((bh, g, d), generator=gen, device=cuda),
        q_pre=torch.randn((bh, n_q, d), generator=gen, device=cuda),
        k=k, v=v, codes=codes, scale=scale, cl=cl.to(torch.int32),
        qpos=qpos.to(torch.int32), table=table.to(torch.int32),
        k_pages=pages(k), v_pages=pages(v), codes_pages=pages(codes),
        scale_pages=scale.reshape(-1)[inv].reshape(-1, 1).contiguous(),
    )


@pytest.mark.parametrize("d", [64, 96, 128])
def test_contiguous_decode_kernels_match_plain_and_paged(cuda, d):
    from repro_torch.kernels import mpmrf_decode as dk

    bk = 64
    c = _contiguous_case(cuda, d, bk)
    qp, qs = _planes(c["q_dec"])
    args = (qp, qs, c["codes"], c["scale"], c["cl"])
    s = dk.mpmrf_decode_filter_scores(*args, key_block=bk)
    r = dk.mpmrf_decode_filter_scores_plain(*args, key_block=bk)
    p = dk.paged_filter_scores(qp, qs, c["codes_pages"], c["scale_pages"],
                               c["table"], c["cl"], key_block=bk)
    for a, b, e in zip(s, r, p):
        assert torch.equal(a, b) and torch.equal(a, e)
    idx = torch.argsort(-s[1], dim=-1, stable=True)[:, :3].to(torch.int32)
    val = (torch.gather(s[1], 1, idx.long()) > -5e29).to(torch.int32)
    q = c["q_dec"].to(torch.bfloat16)
    gargs = (q, c["k"], c["v"], idx, val, c["cl"])
    out = dk.decode_gather_attention(*gargs, key_block=bk)
    ref = dk.decode_gather_attention_plain(*gargs, key_block=bk)
    assert gather_within_tolerance(out.float(), ref.float())
    paged = dk.paged_decode_gather_attention(
        q, c["k_pages"], c["v_pages"], idx, val, c["table"], c["cl"],
        key_block=bk)
    assert torch.equal(out, paged)


@pytest.mark.parametrize("d", [64, 96, 128])
def test_contiguous_prefill_kernels_match_plain_and_paged(cuda, d):
    from repro_torch.kernels import mpmrf_prefill as pk

    bk, bq = 64, 32
    c = _contiguous_case(cuda, d, bk, seed=6)
    qp, qs = _planes(c["q_pre"])
    row_scale = c["scale"].repeat_interleave(bk, dim=-1)
    args = (qp, qs, c["qpos"], c["codes"], row_scale)
    kw = dict(query_block=bq, key_block=bk)
    s = pk.mpmrf_prefill_filter_scores(*args, **kw)
    r = pk.mpmrf_prefill_filter_scores_plain(*args, **kw)
    p = pk.paged_prefill_filter_scores(
        qp, qs, c["qpos"], c["codes_pages"], c["scale_pages"], c["table"],
        **kw)
    for a, b, e in zip(s, r, p):
        assert torch.equal(a, b) and torch.equal(a, e)
    # a key tile of 128 rows over two 64-row scale groups
    wide = dict(query_block=bq, key_block=2 * bk)
    s2 = pk.mpmrf_prefill_filter_scores(*args, **wide)
    r2 = pk.mpmrf_prefill_filter_scores_plain(*args, **wide)
    assert torch.equal(s2[0], r2[0]) and torch.equal(s2[1], r2[1])
    idx = torch.argsort(-s[1], dim=-1, stable=True)[..., :3].to(torch.int32)
    val = (torch.gather(s[1], 2, idx.long()) > -5e29).to(torch.int32)
    q = c["q_pre"].to(torch.bfloat16)
    gargs = (q, c["qpos"], c["k"], c["v"], idx, val)
    out = pk.prefill_gather_attention(*gargs, **kw)
    ref = pk.prefill_gather_attention_plain(*gargs, **kw)
    assert gather_within_tolerance(out.float(), ref.float())
    assert not out[1, -7:].any()           # sentinel rows come out 0
    paged = pk.paged_prefill_gather_attention(
        q, c["qpos"], c["k_pages"], c["v_pages"], idx, val, c["table"], **kw)
    assert torch.equal(out, paged)


def _twin_gathers(cuda, d, bk, bh, n_kb, seed):
    """K/V of a contiguous cache ``[bh, n_k, d]`` and the same rows as
    pages under a shuffled table."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n_k = n_kb * bk
    k, v = (torch.randn((bh, n_k, d), generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    table = torch.randperm(bh * n_kb, generator=gen, device=cuda)
    inv = torch.empty_like(table)
    inv[table] = torch.arange(bh * n_kb, device=cuda)
    pages = lambda x: x.reshape(bh * n_kb, bk, d)[inv].contiguous()
    return gen, k, v, pages(k), pages(v), table.reshape(bh, n_kb).to(
        torch.int32)


#: (G, d, key block, budget) of the split decode gather: G 1 / 5 / 16
#: (and the dense configs' 2 and 9 at d 128),
#: every head-dim instantiation and zero-padded heads (48 on the d-64
#: instantiation; phi3-mini's 96 at G 1, its serving shape, and at G 5
#: over 27 splits; 80 and 112 on the d-128 one), one or two ring tiles
#: per page; budget 7 (two splits, the second short) and 133 (27 splits
#: of 5)
DECODE_SHAPES = [(1, 16, 16, 7), (5, 32, 64, 7), (16, 64, 16, 7),
                 (5, 128, 64, 7), (16, 128, 128, 7), (5, 48, 16, 7),
                 (1, 96, 64, 7), (5, 96, 16, 133), (1, 80, 64, 7),
                 (16, 112, 128, 7), (5, 128, 16, 7), (5, 128, 16, 133),
                 # the dense configs' groups at their serving shape:
                 # gemma3-27b (G 2), starcoder2-7b (G 9)
                 (2, 128, 64, 7), (9, 128, 64, 7), (9, 128, 64, 133)]


@pytest.mark.parametrize("g,d,bk,budget", DECODE_SHAPES)
def test_split_decode_gathers_match_plain_and_each_other(cuda, g, d, bk,
                                                         budget):
    """B6 within the gather tolerance of its plain version, B2 = B6 bit
    for bit on the same rows, both the same when run twice. Row 1's
    second split all invalid, row 2 without a valid slot (0), row 3's
    length cutting inside a block, row 0 an idle slot's max_len + 1."""
    from repro_torch.kernels import mpmrf_decode as dk

    bh, n_kb = 6, budget + 5
    gen, k, v, kp, vp, table = _twin_gathers(cuda, d, bk, bh, n_kb, seed=g)
    n_k = n_kb * bk
    q = torch.randn((bh, g, d), generator=gen, device=cuda).to(torch.bfloat16)
    idx = torch.stack([torch.randperm(n_kb, generator=gen, device=cuda)[
        :budget] for _ in range(bh)]).to(torch.int32)
    val = (torch.rand((bh, budget), generator=gen, device=cuda) < 0.8).to(
        torch.int32)
    val[1, 4:] = 0
    val[2] = 0
    cl = torch.randint(1, n_k + 1, (bh,), generator=gen, device=cuda)
    cl[0] = n_k + 1
    cl[3] = 3 * bk + bk // 2
    idx[3, 0], val[3, 0] = 3, 1                 # the block the length cuts
    cl = cl.to(torch.int32)
    assert dk.decode_splits(budget) == (2 if budget == 7 else 27)
    args = (q, k, v, idx, val, cl)
    out = dk.decode_gather_attention(*args, key_block=bk)
    ref = dk.decode_gather_attention_plain(*args, key_block=bk)
    assert gather_within_tolerance(out.float(), ref.float())
    assert torch.isfinite(out.float()).all() and not out[2].any()
    paged = dk.paged_decode_gather_attention(q, kp, vp, idx, val, table, cl,
                                             key_block=bk)
    assert torch.equal(out, paged)
    assert torch.equal(out, dk.decode_gather_attention(*args, key_block=bk))
    assert torch.equal(paged, dk.paged_decode_gather_attention(
        q, kp, vp, idx, val, table, cl, key_block=bk))


#: (d, query block, key block) of the prefill gather: the wgmma path (d
#: 64 / 128, query blocks of 64 / 128), the mma.sync path (d 16 / 32,
#: query blocks of 16 / 48), pages of one ring tile padded (16), one
#: (64) and two (128) ring tiles
PREFILL_SHAPES = [(16, 16, 16), (32, 48, 64), (64, 64, 64), (128, 128, 64),
                  (128, 128, 128), (128, 48, 16), (64, 128, 16),
                  (128, 16, 64), (96, 128, 64), (96, 48, 16),
                  (80, 64, 128), (112, 16, 64)]


@pytest.mark.parametrize("d,bq,bk", PREFILL_SHAPES)
def test_prefill_gathers_match_plain_and_each_other(cuda, d, bq, bk):
    """B8 within the gather tolerance of its plain version (overall and on
    the rows at positions < 32), B4 = B8 bit for bit on the same rows,
    both the same when run twice. Folded chunks of C = bq/2 rows under 4
    heads, so a query block spans two heads and its positions are not
    contiguous along its rows; row 0's chunk starts at position 0, row
    1 ends in sentinel rows, row 3 is all sentinels (zeros); survivors
    above a block's rows and invalid slots in the tables."""
    from repro_torch.kernels import mpmrf_prefill as pk

    bh, n_kb, budget, heads = 4, 10, 5, 4
    chunk = bq // 2
    gen, k, v, kp, vp, table = _twin_gathers(cuda, d, bk, bh, n_kb,
                                             seed=d + bq + bk)
    n_k = n_kb * bk
    n_q = heads * chunk
    n_qb = n_q // bq
    off = torch.randint(0, n_k - chunk + 1, (bh, 1), generator=gen,
                        device=cuda)
    off[0] = 0
    pos = off + torch.arange(chunk, device=cuda)
    pos[1, -5:] = n_k
    pos[3] = n_k
    qpos = pos.repeat(1, heads).to(torch.int32)            # row (h, c) → c
    q = torch.randn((bh, n_q, d), generator=gen, device=cuda).to(
        torch.bfloat16)
    idx = torch.randint(0, n_kb, (bh, n_qb, budget), generator=gen,
                        device=cuda, dtype=torch.int32)
    val = (torch.rand((bh, n_qb, budget), generator=gen, device=cuda)
           < 0.75).to(torch.int32)
    # the block of each query block's last live position, and block 0
    last = torch.where(qpos < n_k, qpos, -1).reshape(bh, n_qb, bq).amax(-1)
    idx[..., 0], val[..., 0] = (last.clamp(min=0) // bk).to(torch.int32), 1
    idx[..., 1], val[..., 1] = 0, 1
    kw = dict(query_block=bq, key_block=bk)
    args = (q, qpos, k, v, idx, val)
    out = pk.prefill_gather_attention(*args, **kw)
    ref = pk.prefill_gather_attention_plain(*args, **kw)
    assert gather_within_tolerance(out.float(), ref.float())
    early = (qpos < 32).nonzero(as_tuple=True)
    assert gather_within_tolerance(out[early].float(), ref[early].float())
    assert not out[1].reshape(heads, chunk, d)[:, -5:].any()
    assert not out[3].any()
    paged = pk.paged_prefill_gather_attention(q, qpos, kp, vp, idx, val,
                                              table, **kw)
    assert torch.equal(out, paged)
    assert torch.equal(out, pk.prefill_gather_attention(*args, **kw))
    assert torch.equal(paged, pk.paged_prefill_gather_attention(
        q, qpos, kp, vp, idx, val, table, **kw))


@pytest.mark.parametrize("g", [2, 5, 9])
def test_prefill_kernels_at_folded_group_rows(cuda, g):
    """B3 and B4 at the dense configs' serving shape: chunks of 128
    tokens folded over G query heads (G·128 rows: 256 for gemma3-27b,
    640 for qwen3-14b, 1152 for starcoder2-7b) in query blocks of 128,
    d 128, pages of 64. B3 = its plain version bit for bit; B4 within
    the gather tolerance of its plain version, overall and on the rows
    at positions < 32; both the same when run twice. Row 0's chunk is a
    sequence's first, row 1 ends in sentinel rows."""
    _check_folded_prefill(cuda, g, 128)


def test_prefill_kernels_at_qwen3_moe_folded_rows(cuda):
    """The same at qwen3-moe-235b-a22b's serving shape: G 16, chunks of
    64 (1024 folded rows, eight query blocks of 128)."""
    _check_folded_prefill(cuda, 16, 64)


def test_decode_kernels_at_qwen3_moe_group(cuda):
    """B1 and B2 at qwen3-moe-235b-a22b's decode shape: bh 32 (8 slots ×
    4 KV heads), G 16 (the decode filter's limit), d 128, pages of 64,
    lengths up to 4096, budget 16: B1 = its plain version bit for bit,
    B2 within the gather tolerance, twice the same."""
    from repro_torch.kernels import mpmrf_decode as dk

    c = _case(cuda, bh=32, g=16, d=128, bk=64, mb=64, seed=16)
    qp, qs = _planes(c["q_dec"])
    args = (qp, qs, c["codes"], c["scale"], c["table"], c["cl"])
    s = dk.paged_filter_scores(*args, key_block=64)
    r = dk.paged_filter_scores_plain(*args, key_block=64)
    assert torch.equal(s[0], r[0]) and torch.equal(s[1], r[1])
    idx = torch.argsort(-s[1], dim=-1, stable=True)[:, :16].to(torch.int32)
    val = (torch.gather(s[1], 1, idx.long()) > -5e29).to(torch.int32)
    gargs = (c["q_dec"].to(torch.bfloat16), c["k"], c["v"], idx, val,
             c["table"], c["cl"])
    out = dk.paged_decode_gather_attention(*gargs, key_block=64)
    ref = dk.paged_decode_gather_attention_plain(*gargs, key_block=64)
    assert gather_within_tolerance(out.float(), ref.float())
    assert torch.equal(out, dk.paged_decode_gather_attention(
        *gargs, key_block=64))


def _check_folded_prefill(cuda, g, chunk):
    from repro_torch.kernels import mpmrf_prefill as pk

    bh, mb, d, bk, bq, budget = 6, 32, 128, 64, 128, 8
    c = _case(cuda, bh=bh, g=g, d=d, bk=bk, mb=mb, n_q=chunk, bq=bq,
              seed=40 + g)
    n_k = mb * bk
    gen = torch.Generator(device=cuda).manual_seed(g)
    off = torch.randint(0, n_k // chunk, (bh, 1), generator=gen,
                        device=cuda) * chunk
    off[0] = 0
    pos = off + torch.arange(chunk, device=cuda)
    pos[1, -9:] = n_k
    qpos = pos.repeat(1, g).to(torch.int32)             # row (h, c) → c
    q = torch.randn((bh, g * chunk, d), generator=gen, device=cuda)
    qp, qs = _planes(q)
    kw = dict(query_block=bq, key_block=bk)
    args = (qp, qs, qpos, c["codes"], c["scale"], c["table"])
    s = pk.paged_prefill_filter_scores(*args, **kw)
    r = pk.paged_prefill_filter_scores_plain(*args, **kw)
    assert torch.equal(s[0], r[0]) and torch.equal(s[1], r[1])
    again = pk.paged_prefill_filter_scores(*args, **kw)
    assert torch.equal(s[0], again[0]) and torch.equal(s[1], again[1])
    idx = torch.argsort(-s[1], dim=-1, stable=True)[..., :budget].to(
        torch.int32)
    val = (torch.gather(s[1], 2, idx.long()) > -5e29).to(torch.int32)
    gargs = (q.to(torch.bfloat16), qpos, c["k"], c["v"], idx, val,
             c["table"])
    out = pk.paged_prefill_gather_attention(*gargs, **kw)
    ref = pk.paged_prefill_gather_attention_plain(*gargs, **kw)
    assert gather_within_tolerance(out.float(), ref.float())
    early = (qpos < 32).nonzero(as_tuple=True)
    assert gather_within_tolerance(out[early].float(), ref[early].float())
    assert torch.equal(out, pk.paged_prefill_gather_attention(*gargs, **kw))


def test_pallas_engine_at_head_dim_192_is_refused_before_any_launch(cuda):
    """phi3-mini-3.8b's fused config at head dim 192 (2 layers, full
    width, bf16): the kernels take no head dim past 128, so ``ServeLoop``
    refuses the engine at construction, naming the head dim, and nothing
    has launched."""
    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.models import LMModel
    from repro_torch.runtime import ServeLoop

    cfg = dataclasses.replace(registry.get_serve_config("phi3-mini-3.8b"),
                              num_layers=2, head_dim=192)
    assert cfg.energon.impl == "pallas" and cfg.dtype == "bfloat16"
    model = LMModel(cfg, device="cuda")
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim 192 must be a multiple"):
        ServeLoop(model, model.init(seed=0), batch_slots=2, max_len=2048,
                  prefill_chunk=128, device="cuda")
    assert sum(_build.launch_counts.values()) == 0


def test_phi3_serves_on_the_kernels_at_full_width(cuda):
    """phi3-mini-3.8b's serving config at full width (head dim 96, G 1),
    cut to 3 layers so that layer 2 runs the fused kernels: ``ServeLoop``
    builds, serves two 1100-token prompts on B1–B4 (each launched once
    per decode step or prefill wave), and gives the first tokens of the
    same engine with the plain versions swapped in (eager steps both)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_prefill as pk
    from repro_torch.models import LMModel
    from repro_torch.runtime import Request, ServeLoop

    cfg = dataclasses.replace(registry.get_serve_config("phi3-mini-3.8b"),
                              num_layers=3)
    assert cfg.head_dim == 96 and cfg.num_heads == cfg.num_kv_heads
    model = LMModel(cfg, device="cuda")
    params = model.init(seed=0)
    gen = np.random.default_rng(3)
    prompts = [gen.integers(1, cfg.vocab_size - 1, size=1100).tolist()
               for _ in range(2)]

    def drain():
        engine = ServeLoop(model, params, batch_slots=2, max_len=2048,
                           prefill_chunk=128, eos_token=-1,
                           cuda_graphs=False, device="cuda")
        for uid, p in enumerate(prompts):
            engine.submit(Request(uid=uid, prompt=p, max_new_tokens=4))
        _build.reset_launch_counts()
        done = engine.run_until_drained()
        m = engine.metrics
        return ({r.uid: r.tokens_out for r in done}, dict(
            _build.launch_counts), m.decode_dispatches, m.prefill_dispatches)

    streams, n, steps, waves = drain()
    assert n["mpmrf_paged_filter_scores"] == steps > 0
    assert n["paged_decode_gather_attention"] == steps
    assert n["mpmrf_paged_prefill_filter_scores"] == waves > 0
    assert n["paged_prefill_gather_attention"] == waves
    swaps = [(dk, "paged_filter_scores"),
             (dk, "paged_decode_gather_attention"),
             (pk, "paged_prefill_filter_scores"),
             (pk, "paged_prefill_gather_attention")]
    saved = [(m, name, getattr(m, name)) for m, name in swaps]
    try:
        for m, name in swaps:
            setattr(m, name, getattr(m, name + "_plain"))
        plain, n_plain, _, _ = drain()
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    assert sum(n_plain.values()) == 0
    assert all(len(s) == 4 for s in streams.values())
    assert {u: s[:2] for u, s in streams.items()} == {
        u: s[:2] for u, s in plain.items()}


def test_dense_decode_paged_equals_unpaged(cuda):
    """The prefix layers' dense decode over the paged view and over the
    contiguous cache, same rows, at the serving path's shape (8 slots × 8
    KV heads × 4096 rows, G 5, d 128): bit for bit. With the view a
    permuted one, cuBLAS summed in another order (in the last bits), and
    the paged and unpaged engines' greedy streams could part."""
    paged, unpaged, k_log, k = dense_decode_twins(
        cuda, batch=8, heads=8, g=5, d=128, ps=64, mb=64)
    assert k_log.is_contiguous() and torch.equal(k_log, k)
    assert torch.equal(paged, unpaged)


def _decode_filter_case(cuda, g, d, bk, round_bits, repeats, n_kb, seed):
    """B1 / B5 operands: a contiguous code cache of ``6·repeats`` bh rows
    and the same rows as pages under a shuffled table. Rows 0–5 have
    lengths 1, bk − 1, bk, mid-block, n_kb·bk and n_kb·bk + 1 (an idle
    slot's max_len + 1 sentinel), the other rows random lengths. Row 2's
    codes and first q row sit at their most negative (the largest |acc|);
    one live block has scale 0 and one q row a negative scale (the
    per-pair rescale). The table entries past row 0's length alias pages
    that other rows use (an unmapped entry may name any page)."""
    lo, hi = round_bits
    bh = 6 * repeats
    n_k = n_kb * bk
    gen = torch.Generator(device=cuda).manual_seed(seed)
    codes = torch.randint(-32768, 32768, (bh, n_k, d), generator=gen,
                          device=cuda, dtype=torch.int32).to(torch.int16)
    codes[2] = -32768
    scale = torch.rand((bh, n_kb), generator=gen, device=cuda) + 0.05
    scale[3, 1] = 0.0
    half = 1 << (hi - 1)
    q = torch.randint(-half, half, (bh, g, d), generator=gen, device=cuda,
                      dtype=torch.int32)
    q[2, 0] = -half
    qs = torch.rand((bh, g, 1), generator=gen, device=cuda) * 1e-3 + 1e-5
    qs[4, g - 1] = -qs[4, g - 1]
    cl = torch.randint(1, n_k + 2, (bh,), generator=gen, device=cuda)
    cl[:6] = torch.tensor([1, bk - 1, bk, 5 * bk + bk // 2, n_k, n_k + 1],
                          device=cuda).clamp(min=1)
    table = torch.randperm(bh * n_kb, generator=gen, device=cuda)
    inv = torch.empty_like(table)
    inv[table] = torch.arange(bh * n_kb, device=cuda)
    pages = codes.reshape(bh * n_kb, bk, d)[inv].contiguous()
    page_scale = scale.reshape(-1)[inv].reshape(-1, 1).contiguous()
    table = table.reshape(bh, n_kb).to(torch.int32)
    table[0, 1:] = table[1, 0]
    return (q, qs.contiguous(), codes, scale, cl.to(torch.int32), pages,
            page_scale, table)


#: the decode filter (B1 / B5, the decode kind of the filter engine):
#: G of one n8 tile (1, 2, 5, 8) and of two (16), every head dim (d 16 on
#: m16n8k16), key blocks of one m16 tile (16, one warp of four busy) and
#: of four (64, the card's serving path), the (2, 4) planes, the widest
#: at lo 1 and lo = 0 (the code's sign as msb, and a remainder plane
#: reaching 255, past int8)
DECODE_FILTER_GRID = [(g, d, bk, rb) for g in (1, 2, 5, 8, 16)
                      for d in (16, 32, 64, 96, 128) for bk in (16, 64)
                      for rb in ((2, 4), (1, 8), (0, 8))] + [
    # starcoder2-7b's G 9 (two n8 tiles, seven rows padded) at its
    # serving shape
    (9, 128, 64, rb) for rb in ((2, 4), (1, 8), (0, 8))] + [
    # the other head dims the d-128 instantiation runs padded
    (1, 80, 64, (2, 4)), (5, 112, 64, (2, 4))]


def _check_decode_filters(cuda, g, d, bk, round_bits, repeats, n_kb, seed):
    from repro_torch.kernels import mpmrf_decode as dk

    q, qs, codes, scale, cl, pages, page_scale, table = _decode_filter_case(
        cuda, g, d, bk, round_bits, repeats, n_kb, seed)
    kw = dict(round_bits=round_bits, key_block=bk)
    b5 = dk.mpmrf_decode_filter_scores(q, qs, codes, scale, cl, **kw)
    r5 = dk.mpmrf_decode_filter_scores_plain(q, qs, codes, scale, cl, **kw)
    assert torch.equal(b5[0], r5[0]) and torch.equal(b5[1], r5[1])
    again = dk.mpmrf_decode_filter_scores(q, qs, codes, scale, cl, **kw)
    assert torch.equal(b5[0], again[0]) and torch.equal(b5[1], again[1])
    b1 = dk.paged_filter_scores(q, qs, pages, page_scale, table, cl, **kw)
    r1 = dk.paged_filter_scores_plain(q, qs, pages, page_scale, table, cl,
                                      **kw)
    assert torch.equal(b1[0], r1[0]) and torch.equal(b1[1], r1[1])
    again = dk.paged_filter_scores(q, qs, pages, page_scale, table, cl, **kw)
    assert torch.equal(b1[0], again[0]) and torch.equal(b1[1], again[1])
    assert torch.equal(b1[0], b5[0]) and torch.equal(b1[1], b5[1])
    # blocks past the length NEG_INF; the sentinel row masks nothing
    assert (b1[0][0, 1:] == dk.NEG_INF).all()
    assert (b1[1][5] > dk.NEG_INF / 2).all()


@pytest.mark.parametrize("g,d,bk,round_bits", DECODE_FILTER_GRID, ids=[
    f"G{g}-d{d}-bk{bk}-lo{lo}-hi{hi}"
    for g, d, bk, (lo, hi) in DECODE_FILTER_GRID])
def test_decode_filters_match_plain_and_each_other(cuda, g, d, bk,
                                                   round_bits):
    """B1 and B5 = their plain versions bit for bit, the same when run
    twice, and B5 = B1 on the same rows laid out as pages. 132 bh rows of
    16 key blocks: each row's live blocks are cut into runs of about
    four, so the page ring wraps."""
    _check_decode_filters(cuda, g, d, bk, round_bits, repeats=22, n_kb=16,
                          seed=g + d + bk + round_bits[0])


@pytest.mark.parametrize("g,d,bk,round_bits,repeats,n_kb", [
    (5, 128, 8, (2, 4), 22, 16),     # half an m16 tile per page
    (16, 64, 24, (0, 8), 22, 16),    # one and a half
    (5, 128, 128, (1, 8), 22, 16),   # two per warp
    (5, 128, 64, (2, 4), 100, 64),   # 600 rows: one run per row, 64 pages
    (3, 16, 128, (0, 8), 2, 4),      # one block per key block
])
def test_decode_filters_at_other_key_blocks_and_runs(cuda, g, d, bk,
                                                     round_bits, repeats,
                                                     n_kb):
    """The same checks at key blocks of 8 mod 16 keys (the last m16 tile
    half masked), of two m16 tiles per warp, one run of a whole row
    (the ring wraps 16 times) and a run of one block."""
    _check_decode_filters(cuda, g, d, bk, round_bits, repeats, n_kb,
                          seed=7 * g + bk)


# --------------------------------------------------------------------------
# graphed serve steps ≡ eager serve steps
# --------------------------------------------------------------------------

SERVE_LEN, SERVE_CHUNK = 64, 8


@pytest.fixture(scope="module")
def smoke_bf16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_serve_config
    from repro_torch.models import LMModel

    cfg = dataclasses.replace(get_serve_config("qwen3-14b", smoke=True),
                              dtype="bfloat16")
    model = LMModel(cfg, device="cuda")
    return cfg, model, model.init(seed=1)


def _serve_trace(vocab, seed=11):
    """Five requests on one 16-token prefix, request 0's prompt exactly
    two pages (so its second round attaches a page and clones one),
    request 3 sampled at temperature 0.9."""
    rng = np.random.default_rng(seed)
    prefix = [int(x) for x in rng.integers(1, vocab - 1, size=16)]
    out = []
    for uid in range(5):
        n = 16 if uid == 0 else int(rng.integers(3, 20))
        out.append(dict(
            uid=uid, max_new_tokens=12,
            prompt=prefix + [int(x) for x in rng.integers(1, vocab - 1,
                                                          size=n)],
            temperature=0.9 if uid == 3 else 0.0))
    return out


def _drain_twice(smoke, graphs, chunk=SERVE_CHUNK, **kw):
    """The trace served twice on one engine (the second round finds the
    first's prefixes cached): streams, the cache's leaves, the kernels'
    launch counts of both rounds, and the engine."""
    from repro_torch.kernels import _build
    from repro_torch.runtime import Request, ServeLoop

    cfg, model, params = smoke
    engine = ServeLoop(model, params, batch_slots=3, max_len=SERVE_LEN,
                       eos_token=cfg.vocab_size - 1,
                       prefill_chunk=chunk, device="cuda",
                       cuda_graphs=graphs, **kw)
    _build.reset_launch_counts()
    for rnd in range(2):
        for r in _serve_trace(cfg.vocab_size):
            engine.submit(Request(**dict(r, uid=r["uid"] + 100 * rnd)))
        engine.run_until_drained()
    torch.cuda.synchronize()
    streams = {r.uid: list(r.tokens_out) for r in engine.completed}
    # a head-sharded pool's shards, concatenated: the whole pool's layout
    cache = {k: torch.cat(v, dim=1) if isinstance(v, tuple) else v.clone()
             for k, v in engine.cache.items()}
    return streams, cache, dict(_build.launch_counts), engine


@pytest.mark.parametrize("kw", [
    dict(), dict(scheduler="sync"), dict(num_pages=5),
    dict(paged=False), dict(paged=False, scheduler="sync"),
], ids=["paged-hybrid-shared", "paged-sync-shared", "paged-preempting",
        "unpaged-hybrid", "unpaged-sync"])
def test_graphed_drain_equals_eager(smoke_bf16, kw):
    eager, eager_cache, eager_n, eng_e = _drain_twice(smoke_bf16, False, **kw)
    graphed, cache, n, eng = _drain_twice(smoke_bf16, True, **kw)
    assert eng.cuda_graphs and not eng_e.cuda_graphs
    assert [s.captures for s in eng.graphs] == [1, 1]
    assert graphed == eager and len(graphed) == 10
    for key in eager_cache:
        assert torch.equal(cache[key], eager_cache[key]), key
    assert n == eager_n
    paged = kw.get("paged", True)
    names = (("mpmrf_paged_filter_scores", "paged_decode_gather_attention",
              "mpmrf_paged_prefill_filter_scores",
              "paged_prefill_gather_attention") if paged else
             ("mpmrf_decode_filter_scores", "decode_gather_attention",
              "mpmrf_prefill_filter_scores", "prefill_gather_attention"))
    assert all(n[name] > 0 for name in names)
    m = eng.metrics
    assert m.decode_dispatches == eng_e.metrics.decode_dispatches
    if kw == {}:
        assert m.cow_clones > 0 and m.prefix_hits > 0
    if "num_pages" in kw:
        assert m.preemptions > 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_graphed_telemetry_drain_equals_eager_and_plain(smoke_bf16, paged):
    """With device telemetry the engine replays the telemetry variants of
    its steps: the same streams, cache and kernel launches as the plain
    graphed engine, and the same selection counts as the eager telemetry
    steps."""
    from repro_torch.observability import Observability

    plain, plain_cache, plain_n, _ = _drain_twice(smoke_bf16, True,
                                                  paged=paged)
    runs = {}
    for graphs in (False, True):
        obs = Observability()
        streams, cache, n, eng = _drain_twice(smoke_bf16, graphs,
                                              paged=paged, observability=obs)
        runs[graphs] = (streams, obs.sparsity.snapshot(), n)
        assert streams == plain
        for key in plain_cache:
            assert torch.equal(cache[key], plain_cache[key]), key
    assert [s.telemetry for s in eng.graphs] == [True, True]
    assert [s.captures for s in eng.graphs] == [1, 1]
    assert runs[True][1] == runs[False][1]
    assert runs[True][1]["decode"]["dispatches"] > 0
    assert 0.0 < runs[True][1]["decode"]["rho_eff"] <= 1.0
    assert runs[True][2] == runs[False][2] == plain_n


def test_graphed_chaos_drain_equals_eager(smoke_bf16):
    """Injected faults (retried dispatches, NaN poison, denials, storms)
    around graphed steps: the same terminal states, streams, injector
    counts and event trace as the eager engine's."""
    from repro_torch.observability import Observability
    from repro_torch.runtime import FaultInjector, FaultSpec

    out = []
    for graphs in (False, True):
        obs = Observability()
        inj = FaultInjector(seed=7, spec=FaultSpec(
            alloc_failure=0.1, step_exception=0.15, nan_logits=0.02,
            nan_prefill=0.1, preempt_storm=0.1, preempt_storm_size=1))
        streams, _, _, eng = _drain_twice(
            smoke_bf16, graphs, num_pages=8, fault_injector=inj,
            observability=obs, audit=True)
        out.append((streams, {r.uid: r.state for r in eng.terminated},
                    dict(inj.counts), eng.metrics.retries,
                    obs.trace.signature()))
        assert eng.allocator.pages_in_use == 0
    assert out[0] == out[1]
    assert out[1][3] > 0 and "failed" in out[1][1].values()


def _prefilled(smoke, paged, lens=(14, 9)):
    """A cache with two prompts prefilled eagerly (slot 2 idle), its
    block table (one page per slot so far) and the next decode index."""
    cfg, model, params = smoke
    cache = (model.init_paged_cache(12, max_len=SERVE_LEN) if paged
             else model.init_cache(3, SERVE_LEN))
    table = torch.zeros((3, SERVE_LEN // 16), dtype=torch.int32,
                        device="cuda")
    table[0, 0], table[1, 0] = 1, 5
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(1, cfg.vocab_size - 1, (3, 16), generator=gen,
                         device="cuda", dtype=torch.int32)
    pos = torch.full((3, 16), SERVE_LEN, dtype=torch.int32, device="cuda")
    for b, n in enumerate(lens):
        pos[b, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    zero = torch.zeros(3, dtype=torch.int32, device="cuda")
    for c in range(2):
        inputs = {"tokens": toks[:, 8 * c:8 * c + 8],
                  "positions": pos[:, 8 * c:8 * c + 8]}
        if paged:
            inputs["block_table"] = table
        model.prefill(params, cache, inputs, zero)
    index = torch.tensor(list(lens) + [0], dtype=torch.int32, device="cuda")
    return cache, table, index


def test_graphed_decode_replays_after_the_table_gained_a_page(smoke_bf16):
    """Slot 0 steps from 14 to 20 (its page 1 joins the table before
    position 16), slot 1 from 9: each graphed step's logits and the cache
    after equal the eager step's on a twin cache, bit for bit."""
    from repro_torch.runtime import make_serve_step

    _, model, params = smoke_bf16
    (ga, table_g, idx), (ea, table_e, _) = (_prefilled(smoke_bf16, True)
                                            for _ in range(2))
    from repro_torch.kernels import mpmrf_decode
    from repro_torch.runtime.cuda_graph import _capture_stream

    step = make_serve_step(model, device="cuda")
    active = torch.tensor([True, True, False], device="cuda")
    nxt = torch.full((3, 1), 7, dtype=torch.int32, device="cuda")
    for t in range(6):
        if int(idx[0]) == 16:
            table_g[0, 1] = table_e[0, 1] = 2
        if t == 3:
            # a larger call on the capture stream outgrows the gather
            # scratch the graph baked in: the graph goes on reading it
            outgrown = len(mpmrf_decode._outgrown_scratch)
            with torch.cuda.stream(_capture_stream(step.device)):
                mpmrf_decode._split_scratch(nxt, 1024, 8, 128, 16)
            assert len(mpmrf_decode._outgrown_scratch) == outgrown + 1
        inputs = {"tokens": nxt, "active": active}
        lg, _ = step(params, ga, dict(inputs, block_table=table_g), idx)
        le, _ = model.decode_step(params, ea,
                                  dict(inputs, block_table=table_e), idx)
        assert torch.equal(lg, le), t
        nxt = le[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        idx = idx + active.to(torch.int32)
    assert step.captures == 1 and int(idx[0]) == 20
    for key in ga:
        assert torch.equal(ga[key], ea[key]), key


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
@pytest.mark.parametrize("method", ["decode_step", "prefill"])
def test_capture_leaves_the_cache_as_it_was(smoke_bf16, paged, method):
    """Warm-up and capture run with every slot inactive: the cache is bit
    for bit what it was, also a reset page's or slot's scale 0."""
    from repro_torch.runtime.cuda_graph import GraphedStep

    _, model, params = smoke_bf16
    cache, table, index = _prefilled(smoke_bf16, paged)
    if paged:
        model.reset_pages(cache, torch.arange(12, device="cuda") == 9)
    else:
        model.reset_decode_slots(
            cache, torch.tensor([False, False, True], device="cuda"))
    chunk = 1 if method == "decode_step" else SERVE_CHUNK
    inputs = {"tokens": torch.ones((3, chunk), dtype=torch.int32,
                                   device="cuda")}
    if method == "prefill":
        inputs["positions"] = torch.zeros_like(inputs["tokens"])
    if paged:
        inputs["block_table"] = table
        if method == "decode_step":
            inputs["active"] = torch.ones(3, dtype=torch.bool, device="cuda")
    idx = index if method == "decode_step" else torch.zeros_like(index)
    before = {k: v.clone() for k, v in cache.items()}
    assert (cache["k_scale"] == 0).any()
    step = GraphedStep(model, method, torch.device("cuda"))
    step.prepare(params, cache, inputs, idx)
    torch.cuda.synchronize()
    for key in before:
        assert torch.equal(cache[key], before[key]), key
    assert step.capture_seconds > 0 and step.graph_bytes > 0


def test_engines_capture_on_one_stream_and_give_back_their_graphs(
        smoke_bf16):
    """Every capture runs on the device's one capture stream; an engine's
    two steps share a graph memory pool of their own, which goes with
    the engine, to the byte."""
    from repro_torch.runtime import ServeLoop
    from repro_torch.runtime.cuda_graph import _capture_stream

    _, model, params = smoke_bf16

    def engine():
        eng = ServeLoop(model, params, batch_slots=3, max_len=SERVE_LEN,
                        prefill_chunk=SERVE_CHUNK, device="cuda")
        eng.capture_graphs()
        return eng

    a, b = engine(), engine()
    assert a.graphs[0].pool == a.graphs[1].pool != b.graphs[0].pool
    stream = _capture_stream(a.graphs[0].device)
    del a
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    c = engine()
    assert _capture_stream(c.graphs[0].device) is stream
    assert all(s.graph_bytes > 0 for s in c.graphs[:1])
    del c
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() == held


@pytest.mark.parametrize("paged, method, live", [
    (True, "decode_step", "active"), (True, "prefill", "positions"),
    (False, "prefill", "positions"),
], ids=["paged-decode", "paged-prefill", "unpaged-prefill"])
def test_a_graphed_step_needs_the_live_rows(smoke_bf16, paged, method, live):
    """A prefill without ``positions`` or a paged decode without
    ``active`` cannot be captured with every row dead: it is refused."""
    from repro_torch.runtime.cuda_graph import GraphedStep

    _, model, params = smoke_bf16
    cache, table, index = _prefilled(smoke_bf16, paged)
    chunk = 1 if method == "decode_step" else SERVE_CHUNK
    inputs = {"tokens": torch.ones((3, chunk), dtype=torch.int32,
                                   device="cuda")}
    if paged:
        inputs["block_table"] = table
    step = GraphedStep(model, method, torch.device("cuda"))
    with pytest.raises(ValueError, match=f"needs inputs\\['{live}'\\]"):
        step.prepare(params, cache, inputs, index)
    assert step.captures == 0


# --------------------------------------------------------------------------
# the chunked kernel route, XLA ≡ fused selection, the XLA serve steps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d,n,q_offset,ratio", [
    (128, 4096, 0, 4.0), (128, 4096, 2048, 4.0), (64, 3072, 0, 2.0),
    (128, 2560, 0, 1.0), (96, 4096, 0, 4.0),
])
def test_chunked_kernel_route_equals_scan(cuda, d, n, q_offset, ratio):
    """Past the threshold: B9 → selection → B10 against the torch scan
    on bf16 operands — the survivor tables bit for bit, the outputs
    within the gather tolerance (both keep P at f32); B11 against the
    scan's dense chunks the same way."""
    from repro_torch.core import chunked_attention as chk
    from repro_torch.kernels import ops

    gen = torch.Generator(device=cuda).manual_seed(n + d)
    b, h = 1, 4
    q = torch.randn((b, h, n - q_offset, d), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    k, v = (torch.randn((b, h, n, d), generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    kw = dict(pruning_ratio=ratio, query_block=128, key_block=64,
              q_offset=q_offset)
    ref = chk.energon_block_attention_chunked(q, k, v, **kw)
    flat = lambda x: x.reshape(b * h, -1, d)
    out = ops.chunked_block_attention(flat(q), flat(k), flat(v), **kw)
    (kidx, kval), (idx, val) = chunked_tables(
        q, k, pruning_ratio=ratio, query_block=128, key_block=64,
        q_offset=q_offset)
    assert torch.equal(kidx, idx) and torch.equal(kval, val)
    assert gather_within_tolerance(out.float(), flat(ref).float())
    dense = ops.flash_attention(flat(q), flat(k), flat(v), q_offset=q_offset)
    dref = chk.dense_attention_chunked(q, k, v, q_offset=q_offset)
    assert gather_within_tolerance(dense.float(), flat(dref).float())


def _random_cache(cuda, *, batch=3, heads=2, n_k=1024, d=128, bk=64,
                  seed=0):
    from repro_torch.core import quantization as qlib

    gen = torch.Generator(device=cuda).manual_seed(seed)
    k, v = (torch.randn((batch, heads, n_k, d), generator=gen, device=cuda
                        ).to(torch.bfloat16) for _ in range(2))
    codes, scale = qlib.quantize_int16_blocks(k, bk)
    mb = n_k // bk
    table = torch.randperm(batch * mb, generator=gen, device=cuda).reshape(
        batch, mb).to(torch.int32)
    inv = torch.empty(batch * mb, dtype=torch.long, device=cuda)
    inv[table.reshape(-1).long()] = torch.arange(batch * mb, device=cuda)

    def pool(x):                 # [B, KV, n_k, ...] → [KV, pages·bk, ...]
        x = x.reshape(batch, heads, mb, bk, -1).movedim(1, 0).reshape(
            heads, batch * mb, bk, -1)[:, inv]
        return x.reshape(heads, batch * mb * bk, -1)

    cache = {"k": pool(k), "v": pool(v),
             "k_codes": pool(codes),
             "k_scale": scale.movedim(1, 0).reshape(heads, -1)[:, inv]}
    return gen, k, v, codes, scale, table, cache


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_xla_selection_equals_the_fused_kernels(cuda, monkeypatch, paged,
                                                kind):
    """``impl="mpmrf_block"`` (the XLA paths) and ``impl="pallas"`` (the
    fused kernels) on the same cache select the same survivor blocks, bit
    for bit, at the serving shapes' key blocks (64) and G = 5."""
    from repro_torch.core import EnergonConfig
    from repro_torch.core import sparse_attention as spa
    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_prefill as pk

    ea_mod = importlib.import_module("repro_torch.core.energon_attention")
    gen, k, v, codes, scale, table, cache = _random_cache(cuda, seed=3)
    batch, heads, n_k, d = k.shape
    seen = {}

    def hook(mod, name, key, pick):
        real = getattr(mod, name)

        def hooked(*a, **kw):
            seen[key] = pick(a, kw)
            return real(*a, **kw)

        monkeypatch.setattr(mod, name, hooked)

    if kind == "decode":
        g = 5
        q = torch.randn((batch, heads, g, d), generator=gen, device=cuda
                        ).to(torch.bfloat16)
        cl = torch.tensor([1, 700, n_k], dtype=torch.int32, device=cuda)
        if paged:
            hook(dk, "paged_decode_gather_attention", "fused",
                 lambda a, kw: (a[3], a[4]))
            hook(spa, "paged_decode_block_gather_attention", "xla",
                 lambda a, kw: (a[3], a[4]))
        else:
            hook(dk, "decode_gather_attention", "fused",
                 lambda a, kw: (a[3], a[4]))
            hook(spa, "decode_block_gather_attention", "xla",
                 lambda a, kw: (a[3], a[4]))
        for impl in ("pallas", "mpmrf_block"):
            cfg = EnergonConfig(impl=impl, key_block=64, decode_key_block=64,
                                min_prune_layer=0)
            if paged:
                ea_mod.energon_paged_decode_attention(q, cache, table, cl,
                                                      cfg)
            else:
                ea_mod.energon_decode_attention(
                    q, k, v, cl, cfg,
                    filter_cache={"codes": codes, "scale": scale})
    else:
        n_q = 5 * 128
        q = torch.randn((batch, heads, n_q, d), generator=gen, device=cuda
                        ).to(torch.bfloat16)
        start = torch.tensor([0, 300, n_k - 128], device=cuda)
        qpos = (start[:, None] + torch.arange(128, device=cuda)).repeat(
            1, 5)
        qpos = torch.where(qpos < n_k, qpos, n_k).to(torch.int32)
        qpos[0, 100:128] = n_k                 # a ragged chunk's sentinels
        if paged:
            hook(pk, "paged_prefill_gather_attention", "fused",
                 lambda a, kw: (a[4], a[5]))
        else:
            hook(pk, "prefill_gather_attention", "fused",
                 lambda a, kw: (a[4], a[5]))
        hook(spa, "block_gather_attention", "xla",
             lambda a, kw: (a[3], kw["block_valid"]))
        for impl in ("pallas", "mpmrf_block"):
            cfg = EnergonConfig(impl=impl, key_block=64, decode_key_block=64,
                                query_block=128, min_prune_layer=0)
            if paged:
                ea_mod.energon_paged_prefill_attention(q, cache, table, qpos,
                                                       cfg)
            else:
                ea_mod.energon_attention(
                    q, k, v, cfg, q_positions=qpos,
                    filter_cache={"codes": codes, "scale": scale})
    f_idx, f_val = seen["fused"]
    x_idx, x_val = seen["xla"]
    # a padded slot points at block 0 on both paths
    assert torch.equal(f_idx, x_idx.reshape(f_idx.shape))
    assert torch.equal(f_val, x_val.reshape(f_val.shape))


@pytest.fixture(scope="module")
def smoke_bf16_block():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_serve_config
    from repro_torch.models import LMModel

    base = get_serve_config("qwen3-14b", smoke=True)
    cfg = dataclasses.replace(base, dtype="bfloat16", energon=(
        dataclasses.replace(base.energon, impl="mpmrf_block")))
    model = LMModel(cfg, device="cuda")
    return cfg, model, model.init(seed=1)


@pytest.mark.parametrize("kw", [dict(), dict(paged=False)],
                         ids=["paged", "unpaged"])
def test_graphed_xla_drain_equals_eager(smoke_bf16_block, kw):
    """``impl="mpmrf_block"`` (the reference's default: the XLA selection
    and gather paths, no kernel) replayed from CUDA graphs equals its
    eager steps bit for bit: streams, cache, and no kernel launched."""
    eager, eager_cache, eager_n, _ = _drain_twice(smoke_bf16_block, False,
                                                  **kw)
    graphed, cache, n, eng = _drain_twice(smoke_bf16_block, True, **kw)
    assert [s.captures for s in eng.graphs] == [1, 1]
    assert graphed == eager and len(graphed) == 10
    for key in eager_cache:
        assert torch.equal(cache[key], eager_cache[key]), key
    assert sum(n.values()) == sum(eager_n.values()) == 0


@pytest.fixture(scope="module")
def gemma_bf16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_serve_config
    from repro_torch.models import LMModel

    cfg = dataclasses.replace(get_serve_config("gemma3-27b", smoke=True),
                              dtype="bfloat16")
    model = LMModel(cfg, device="cuda")
    return cfg, model, model.init(seed=1)


@pytest.mark.parametrize("kw", [dict(), dict(paged=False)],
                         ids=["paged", "unpaged"])
def test_graphed_windowed_drain_equals_eager(gemma_bf16, kw):
    """gemma3-27b's serve-smoke model (5 windowed layers on the XLA paths,
    global layer 5 on the fused kernels, the tied head, GeGLU) replayed
    from CUDA graphs equals its eager steps bit for bit: streams past the
    window of 16, cache and launch counts, the fused kernels launched."""
    eager, eager_cache, eager_n, _ = _drain_twice(gemma_bf16, False, **kw)
    graphed, cache, n, eng = _drain_twice(gemma_bf16, True, **kw)
    assert [s.captures for s in eng.graphs] == [1, 1]
    assert graphed == eager and len(graphed) == 10
    for key in eager_cache:
        assert torch.equal(cache[key], eager_cache[key]), key
    assert n == eager_n and all(
        n[k] > 0 for k in (("mpmrf_paged_filter_scores",
                            "paged_decode_gather_attention")
                           if kw.get("paged", True) else
                           ("mpmrf_decode_filter_scores",
                            "decode_gather_attention")))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_one_slot_and_one_sequence_run_the_kernels(gemma_bf16, paged):
    """One slot and one scored sequence, whose heads reshape to strided
    views: the kernels get contiguous operands and launch (a one-sequence
    ``loss`` once raised at B9), graphed, and every token comes."""
    from repro_torch.kernels import _build
    from repro_torch.runtime import Request, ServeLoop

    cfg, model, params = gemma_bf16
    prompt = list(range(1, 40))

    engine = ServeLoop(model, params, batch_slots=1, max_len=SERVE_LEN,
                       prefill_chunk=SERVE_CHUNK, eos_token=-1, paged=paged,
                       device="cuda")
    engine.submit(Request(uid=0, prompt=prompt, max_new_tokens=6))
    _build.reset_launch_counts()
    done = engine.run_until_drained()
    assert len(done[0].tokens_out) == 6 and done[0].error is None
    assert sum(_build.launch_counts.values()) > 0
    toks = torch.randint(1, cfg.vocab_size - 1, (1, 64), device="cuda")
    _build.reset_launch_counts()
    loss, _ = model.loss(params, {"inputs": toks, "targets": toks})
    assert torch.isfinite(loss)
    assert _build.launch_counts["mpmrf_filter_scores"] == 1
    assert _build.launch_counts["block_sparse_attention"] == 1


# --------------------------------------------------------------------------
# serving over a mesh of the one card
# --------------------------------------------------------------------------

PAGED_KERNELS = ("mpmrf_paged_filter_scores", "paged_decode_gather_attention",
                 "mpmrf_paged_prefill_filter_scores",
                 "paged_prefill_gather_attention")


def _card_mesh(d, m):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((d, m), ("data", "model"), ["cuda:0"] * (d * m))


@pytest.fixture(scope="module")
def smoke_kv4_bf16(smoke_bf16):
    """The serve-smoke model with four KV heads (G 2): a (1, 4) mesh
    splits it one head a shard."""
    from repro_torch.models import LMModel

    cfg = dataclasses.replace(smoke_bf16[0], num_kv_heads=4)
    model = LMModel(cfg, device="cuda")
    return cfg, model, model.init(seed=2)


@pytest.mark.parametrize("kv,m", [(2, 2), (4, 4)],
                         ids=["kv2-mesh1x2", "kv4-mesh1x4"])
def test_tp_mesh_graphed_equals_eager_and_single_engine(
        smoke_bf16, smoke_kv4_bf16, kv, m):
    smoke = smoke_bf16 if kv == 2 else smoke_kv4_bf16
    single, single_cache, single_n, _ = _drain_twice(smoke, True)
    eager, eager_cache, eager_n, eng_e = _drain_twice(
        smoke, False, mesh=_card_mesh(1, m))
    graphed, cache, n, eng = _drain_twice(smoke, True, mesh=_card_mesh(1, m))
    assert eng.cuda_graphs and eng.graph_mode == "graphed"
    assert not eng_e.cuda_graphs
    assert [s.captures for s in eng.graphs] == [1, 1]
    assert len(eng.cache["k"]) == m
    assert graphed == eager == single and len(single) == 10
    for key in single_cache:
        assert torch.equal(eager_cache[key], single_cache[key]), key
        assert torch.equal(cache[key], single_cache[key]), key
    assert n == eager_n
    for name in PAGED_KERNELS:
        assert n[name] == m * single_n[name] > 0, name


def test_replicated_mesh_drain_equals_single_engine(smoke_bf16):
    from repro_torch.kernels import _build
    from repro_torch.runtime import ReplicatedServeLoop, Request

    cfg, model, params = smoke_bf16
    single, _, single_n, _ = _drain_twice(smoke_bf16, True)
    loop = ReplicatedServeLoop(
        model, params, mesh=_card_mesh(2, 2), batch_slots=3,
        max_len=SERVE_LEN, eos_token=cfg.vocab_size - 1,
        prefill_chunk=SERVE_CHUNK, device="cuda")
    loop.capture_graphs()
    _build.reset_launch_counts()
    for rnd in range(2):
        for r in _serve_trace(cfg.vocab_size):
            loop.submit(Request(**dict(r, uid=r["uid"] + 100 * rnd)))
        loop.run_until_drained()
    torch.cuda.synchronize()
    streams = {r.uid: list(r.tokens_out) for r in loop.completed}
    assert streams == single
    assert all(e.cuda_graphs and len(e.cache["k"]) == 2
               for e in loop.engines)
    assert len(set(loop.placement.values())) == 2
    n = dict(_build.launch_counts)
    assert all(n[name] > 0 for name in PAGED_KERNELS)
    merged = loop.merged_metrics()
    assert merged.decode_tokens == sum(e.metrics.decode_tokens
                                       for e in loop.engines)


# --------------------------------------------------------------------------
# the MoE layer (olmoe-1b-7b's widths) and the MoE model on the card

# --------------------------------------------------------------------------

#: olmoe-1b-7b's MoE serve shapes: a decode step of 8 slots, a prefill
#: wave of 8 slots × 128 rows
MOE_SHAPES = {"decode": (8, 1), "prefill": (8, 128)}


@pytest.fixture(scope="module")
def olmoe_layer():
    """One MoE layer at olmoe-1b-7b's published widths (64 experts top-8,
    d 2048, d_ff 1024): random bf16 experts and an f32 router from a
    seed, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.models import LMModel
    from repro_torch.models import moe

    cfg = LMModel(get_config("olmoe-1b-7b"), device="meta")._moe_cfg()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = moe.init_moe(cfg, gen, "cuda", torch.bfloat16)
    return cfg, params


def _moe_input(cfg, kind, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, n = MOE_SHAPES[kind]
    return torch.randn((b, n, cfg.d_model), generator=gen,
                       device="cuda").to(torch.bfloat16)


def _captured_moe(cfg, params, x):
    """``apply_moe`` on the static input ``x`` captured in a CUDA graph
    (warmed up on a side stream first): the graph and its outputs."""
    from repro_torch.models import moe

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            moe.apply_moe(params, x, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, metrics = moe.apply_moe(params, x, cfg)
    return graph, out, metrics


@pytest.mark.parametrize("kind", list(MOE_SHAPES))
def test_moe_layer_graphed_equals_eager(olmoe_layer, kind):
    """The routing, dispatch, expert bmm and combine replayed from a CUDA
    graph give the eager call's bits, output and metrics, at the decode
    step's and the prefill wave's shapes."""
    from repro_torch.models import moe

    cfg, params = olmoe_layer
    x = _moe_input(cfg, kind)
    graph, out, metrics = _captured_moe(cfg, params, x)
    x.copy_(_moe_input(cfg, kind, seed=2))      # a replay reads the new x
    graph.replay()
    torch.cuda.synchronize()
    eager, eager_metrics = moe.apply_moe(params, x, cfg)
    assert torch.equal(out, eager) and torch.isfinite(out).all()
    for key in eager_metrics:
        assert torch.equal(metrics[key], eager_metrics[key]), key
    if kind == "decode":       # capacity 1: 64 assignments into 64 experts
        assert 0 < float(eager_metrics["moe_drop_fraction"]) < 1


@pytest.mark.parametrize("kind", list(MOE_SHAPES))
def test_moe_combine_bits_are_stable_across_replays(olmoe_layer, kind):
    """Three replays on the same input give the same bits: the combine
    sums each token's K contributions in a fixed order (no atomics)."""
    cfg, params = olmoe_layer
    x = _moe_input(cfg, kind)
    graph, out, _ = _captured_moe(cfg, params, x)
    seen = []
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        seen.append(out.clone())
    assert all(torch.equal(seen[0], s) for s in seen[1:])


def test_olmoe_smoke_decode_step_matches_the_cpu(cuda):
    """olmoe's smoke model (fp32, impl mpmrf_row at ρ = 1, contiguous
    cache): a prefill chunk then one decode step on the card against the
    same calls on the CPU, logits within 1e-4 (ρ = 1 keeps every row, so
    a code on a rounding boundary cannot flip a selection)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import LMModel

    cfg = get_smoke_config("olmoe-1b-7b")
    cfg = dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, pruning_ratio=1.0))
    cpu = LMModel(cfg, device="cpu")
    params = cpu.init(seed=0)
    card = LMModel(cfg, device="cuda")
    card_params = _to(params, "cuda")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size - 1, size=(2, 16)).astype(np.int32)
    outs = {}
    for dev, model, p in (("cpu", cpu, params), ("cuda", card, card_params)):
        cache = model.init_cache(2, 64)
        zero = torch.zeros(2, dtype=torch.int32, device=dev)
        pos = torch.arange(16, dtype=torch.int32, device=dev).expand(2, 16)
        pre, cache = model.prefill(
            p, cache, {"tokens": torch.from_numpy(toks).to(dev),
                       "positions": pos.contiguous()}, zero)
        nxt = pre[:, -1].argmax(-1).to(torch.int32)[:, None]
        dec, _ = model.decode_step(
            p, cache, {"tokens": nxt}, torch.full((2,), 16, dtype=torch.int32,
                                                  device=dev))
        outs[dev] = (pre.cpu(), dec.cpu())
    for got, want in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# --------------------------------------------------------------------------
# expert parallelism on a mesh of the one card
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def olmoe_smoke_bf16():
    """olmoe-1b-7b's serve-smoke model (3 layers, 8 experts top-2, 4 / 4
    heads of 16) in bf16 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_serve_config
    from repro_torch.models import LMModel

    cfg = dataclasses.replace(get_serve_config("olmoe-1b-7b", smoke=True),
                              dtype="bfloat16", num_layers=3)
    model = LMModel(cfg, device="cuda")
    return cfg, model, model.init(seed=3)


@pytest.mark.parametrize("m", [2, 4])
def test_ep_mesh_graphed_equals_eager(olmoe_smoke_bf16, m):
    """An MoE engine on ``cuda:0`` × M: the experts split over the model
    axis (views), the expert-parallel layer in every step; the graphed
    drain gives the eager drain's streams and launches, and B1–B4 run
    once per shard (M divides the 4 KV heads). Chunks of 16: at G 1 the
    fused prefill needs the query block's 16 rows."""
    graphed, _, n, eng = _drain_twice(olmoe_smoke_bf16, True, chunk=16,
                                      mesh=_card_mesh(1, m))
    eager, _, eager_n, _ = _drain_twice(olmoe_smoke_bf16, False, chunk=16,
                                        mesh=_card_mesh(1, m))
    assert eng.cuda_graphs and [s.captures for s in eng.graphs] == [1, 1]
    assert isinstance(eng.params["blocks"]["moe"]["w_up"], tuple)
    assert graphed == eager and len(graphed) == 10
    assert n == eager_n
    for name in PAGED_KERNELS:
        assert n[name] > 0 and n[name] % m == 0, name


@pytest.mark.parametrize("kind", list(MOE_SHAPES))
def test_ep_layer_on_the_card_matches_the_cpu(olmoe_layer, kind):
    """olmoe-1b-7b's MoE layer on a ``cuda:0`` × 4 mesh (16 experts a
    shard) against the port's expert-parallel layer on ``cpu`` × 4 in
    f32 from the same bf16 tensors: within 2^-7 on the rows routed alike
    (the tolerance of ``chip_smoke.py``'s ``[olmoe-moe-layer]``), which
    are most rows."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    cfg, params = olmoe_layer
    x = _moe_input(cfg, kind, seed=5)
    with shd.active_mesh(_card_mesh(1, 4)):
        out, _ = moe.apply_moe(params, x, cfg)
    p_cpu = {k: v.float().cpu() for k, v in params.items()}
    with shd.active_mesh(make_mesh((1, 4), ("data", "model"), ["cpu"] * 4)):
        ref, _ = moe.apply_moe(p_cpu, x.float().cpu(), cfg)
    d, k = cfg.d_model, cfg.experts_per_token
    xt = x.reshape(-1, d)
    _, _, top_e, _, keep, _ = moe.route(params, xt, cfg)
    _, _, c_top_e, _, c_keep, _ = moe.route(p_cpu, xt.float().cpu(), cfg)
    alike = ((top_e.cpu() == c_top_e).all(-1)
             & (keep.cpu() == c_keep).view(-1, k).all(-1))
    assert alike.float().mean() > 0.9
    got, want = out.float().cpu().reshape(-1, d), ref.reshape(-1, d)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[alike], want[alike], atol=2.0 ** -7,
                               rtol=2.0 ** -7)



# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def test_one_train_step_on_the_card_matches_the_cpu(cuda):
    """qwen3-14b's smoke model (fp32, mpmrf_row at ρ = 1, remat "dots"):
    one ``make_train_step`` step of 2 microbatches on the card against
    the same step on the CPU from the same weights and batch. The loss
    within rtol 1e-5 and the grad norm within 1e-4 (the same f32 graph
    in other summation orders, TF32 off); the params within 1e-5 on all
    but 0.1 % of each leaf and every one within 2·lr (a first AdamW step
    moves a weight by ≈ lr·sign(g), which a gradient near 0 may flip)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import LMModel
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.runtime import make_train_step

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_smoke_config("qwen3-14b")
    cfg = dataclasses.replace(cfg, remat="dots", energon=dataclasses.replace(
        cfg.energon, pruning_ratio=1.0))
    lr = 1e-3
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(1, 255, size=(4, 64)).astype(np.int32)
             for k in ("inputs", "targets")}
    out = {}
    for dev in ("cpu", "cuda"):
        model = LMModel(cfg, device=dev)
        params = _to(LMModel(cfg, device="cpu").init(seed=0), dev)
        opt = AdamWConfig(learning_rate=lr)
        step = make_train_step(model, opt, num_microbatches=2)
        params, state, m = step(params, adamw.init(params, opt), batch)
        out[dev] = (_to(params, "cpu"), float(m["loss"]),
                    float(m["grad_norm"]))
    (p_cpu, loss_cpu, gn_cpu), (p_card, loss_card, gn_card) = (
        out["cpu"], out["cuda"])
    np.testing.assert_allclose(loss_card, loss_cpu, rtol=1e-5)
    np.testing.assert_allclose(gn_card, gn_cpu, rtol=1e-4)
    leaves = lambda tree: (
        [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, dict) else [tree])
    for a, b in zip(leaves(p_card), leaves(p_cpu)):
        diff = (a - b).abs()
        assert float((diff > 1e-5).float().mean()) <= 1e-3
        assert float(diff.max()) <= 2 * lr


def test_pallas_loss_under_grad_is_refused_on_the_card(cuda):
    """The CUDA kernels have no backward: the direct pallas route raises
    under grad on the card as on the CPU, and scores without grad."""
    from repro_torch.configs.registry import get_serve_config
    from repro_torch.models import LMModel
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_serve_config("qwen3-14b", smoke=True),
                              dtype="bfloat16")
    model = LMModel(cfg, device="cuda")
    params = model.init(seed=0)
    toks = torch.randint(1, 255, (2, 64), device="cuda", dtype=torch.int32)
    batch = {"inputs": toks, "targets": toks}
    with torch.no_grad():
        loss, _ = model.loss(params, batch)
    assert torch.isfinite(loss)
    with pytest.raises(NotImplementedError, match="mpmrf_block"):
        adamw.accumulate_gradients(model.loss, params, batch, 1)

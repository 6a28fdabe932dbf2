"""The CUDA kernels against their plain versions on the card (B1–B11),
and the contiguous twins B5–B8 against the paged B1–B4 on the same rows.

Marked ``gpu``: on a host without CUDA every case skips. On the GPU
machine run ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_cuda.py`` (``--noconftest``: the suite's conftest
imports ``jax``). ``python3 chip_smoke.py`` makes the same checks at the
serving shapes.
Filter scores must be bit-equal; bf16 gathers agree within
``repro_torch.kernels.gather_within_tolerance`` (both sides compute in
f32 and round the output once: at most one bf16 ulp apart)."""

import pytest
import torch

from repro_torch.kernels import gather_within_tolerance

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


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 48),
                                             (False, 0)])
@pytest.mark.parametrize("d,bq,bk", [(16, 16, 16), (128, 128, 64)])
def test_filter_kernel_matches_plain(cuda, d, bq, bk, causal, q_offset):
    from repro_torch.kernels import mpmrf_filter as fk

    args = _planes_full_sequence(cuda, 6, 256, d, seed=2)
    kw = dict(query_block=bq, key_block=bk, shift=2, causal=causal,
              q_offset=q_offset)
    out = fk.mpmrf_filter_scores(*args, **kw)
    ref = fk.mpmrf_filter_scores_plain(*args, **kw)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def _qkv(cuda, bh, n, d, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(3)]


#: every instantiation and tiling of the B10/B11 tile engine: d ∈ {16,
#: 32, 64, 128}, one to eight warps, a key block of 8 (one ring tile
#: padded with masked keys), of 16, of one ring tile (64) and of two (128)
ENGINE_SHAPES = [(16, 16, 8), (32, 32, 16), (64, 64, 64), (128, 128, 64),
                 (128, 128, 128)]
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


@pytest.mark.parametrize("d", [64, 128])
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


@pytest.mark.parametrize("d", [64, 128])
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

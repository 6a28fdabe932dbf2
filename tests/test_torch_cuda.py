"""The CUDA kernels against their plain versions on the card.

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

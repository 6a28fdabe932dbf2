"""The port's collectives (``distributed/collectives.py``) on the CPU:
each one's forward equals the single-tensor op it stands for, and its
backward is that op's transpose.

* all-gather ≡ ``torch.cat``; its backward sums the copies' gradients
  and hands each part its slice (a reduce-scatter);
* reduce-scatter ≡ the sum split into slices; its backward gathers;
* all-reduce ≡ the sum, held once; its backward broadcasts;
* broadcast ≡ copies; its backward sums the copies' gradients.

Each is checked against the same composition of plain ops under
autograd, and by ``torch.autograd.gradcheck`` in float64. Cross-part
sums of bf16 parts run in f32 and round once (not a chain of bf16
adds). The int8 gather: per-row codes and scales, ``codes · scale`` in
the parts' dtype, the exact f32 gradient (its parity with the
reference's ``_quantized_all_gather`` is in ``test_torch_mesh_train.py``,
which runs the reference on a mesh).
"""

import pytest
import torch

from repro_torch.distributed import collectives as col

CPU = torch.device("cpu")


def _parts(n=3, shape=(4, 5), dtype=torch.float64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dtype).requires_grad_()
            for _ in range(n)]


@pytest.mark.parametrize("dim", [0, 1])
def test_all_gather_is_cat_and_its_backward_reduce_scatters(dim):
    parts = _parts()
    outs = col.all_gather(parts, dim, [CPU, CPU], axes=("data",))
    want = torch.cat([p.detach() for p in parts], dim=dim)
    assert all(torch.equal(o, want) for o in outs)
    g = [torch.randn_like(o) for o in outs]
    torch.autograd.backward(outs, g)
    total = g[0] + g[1]
    for p, piece in zip(parts, total.split(4 if dim == 0 else 5, dim=dim)):
        assert torch.equal(p.grad, piece)
    assert torch.autograd.gradcheck(
        lambda *ps: tuple(col.all_gather(ps, dim, [CPU, CPU],
                                         axes=("data",))),
        tuple(_parts()))


def test_reduce_scatter_is_a_split_sum_and_its_backward_gathers():
    parts = _parts(n=2, shape=(6, 3))
    outs = col.reduce_scatter(parts, 0, axes=("data",))
    total = parts[0].detach() + parts[1].detach()
    assert [torch.equal(o, w) for o, w in zip(outs, total.split(3))] == [
        True, True]
    g = [torch.randn_like(o) for o in outs]
    torch.autograd.backward(outs, g)
    for p in parts:
        assert torch.equal(p.grad, torch.cat(g))
    assert torch.autograd.gradcheck(
        lambda *ps: tuple(col.reduce_scatter(ps, 0, axes=("data",))),
        tuple(_parts(n=2, shape=(6, 3))))


def test_all_reduce_is_the_sum_and_its_backward_broadcasts():
    parts = _parts()
    out = col.all_reduce(parts, axes=("model",))
    assert torch.equal(out, parts[0] + parts[1] + parts[2])
    g = torch.randn_like(out)
    out.backward(g)
    assert all(torch.equal(p.grad, g) for p in parts)
    assert torch.autograd.gradcheck(
        lambda *ps: col.all_reduce(ps, axes=("model",)), tuple(_parts()))


def test_broadcast_is_copies_and_its_backward_sums():
    x = _parts(n=1)[0]
    outs = col.broadcast(x, [CPU, CPU, CPU], axes=("model",))
    assert all(torch.equal(o, x) for o in outs)
    # a copy onto the device it lives on is a view, not memory
    assert all(o.data_ptr() == x.data_ptr() for o in outs)
    g = [torch.randn_like(o) for o in outs]
    torch.autograd.backward(outs, g)
    assert torch.equal(x.grad, g[0] + g[1] + g[2])
    assert torch.autograd.gradcheck(
        lambda y: tuple(col.broadcast(y, [CPU, CPU], axes=("model",))),
        (_parts(n=1)[0],))


def test_bf16_sums_run_in_f32_and_round_once():
    # 1 + 2^-8 + 2^-8: bf16 adds lose both halves, f32 keeps their sum
    parts = [torch.full((3,), v, dtype=torch.bfloat16)
             for v in (1.0, 2.0 ** -8, 2.0 ** -8)]
    chained = parts[0] + parts[1] + parts[2]
    once = (parts[0].float() + parts[1].float() + parts[2].float()).to(
        torch.bfloat16)
    assert not torch.equal(chained, once)
    assert torch.equal(col.all_reduce(parts, axes=("model",)), once)
    assert torch.equal(
        torch.cat(col.reduce_scatter(parts, 0, axes=("data",))), once)
    x = torch.zeros(3, dtype=torch.bfloat16, requires_grad=True)
    outs = col.broadcast(x, [CPU] * 3, axes=("model",))
    torch.autograd.backward(outs, parts)
    assert torch.equal(x.grad, once)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [0, 1])
def test_quantized_all_gather_codes_scales_and_exact_gradient(dtype, dim):
    parts = [p.detach().to(dtype).requires_grad_()
             for p in _parts(n=2, shape=(6, 8), dtype=torch.float32)]
    outs = col.quantized_all_gather(parts, dim, [CPU, CPU],
                                    axes=("data",))
    pieces = []
    for p in parts:
        codes, scale = col.quantize_rows(p.detach(), dim)
        assert codes.dtype == torch.int8 and codes.abs().max() <= 127
        assert scale.shape[dim] == 1
        if dtype == torch.float32:   # each row's largest |w| lands on ±127
            assert torch.equal(codes.abs().amax(dim=dim),
                               torch.full_like(codes.abs().amax(dim=dim),
                                               127))
        pieces.append(codes.to(dtype) * scale.to(dtype))
    want = torch.cat(pieces, dim=dim)
    assert all(torch.equal(o, want) for o in outs)
    err = (want.float() - torch.cat([p.detach() for p in parts], dim=dim)
           .float()).abs()
    assert float(err.max()) <= float(max(p.detach().float().abs().max()
                                         for p in parts)) / 127
    g = [torch.randn(o.shape).to(dtype) for o in outs]
    torch.autograd.backward(outs, g)
    total = (g[0].float() + g[1].float()).to(dtype)
    for p, piece in zip(parts, total.split(6 if dim == 0 else 8, dim=dim)):
        assert torch.equal(p.grad, piece)

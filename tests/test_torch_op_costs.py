"""The op-cost walk (``repro_torch.analysis.op_costs``), on the CPU.

* The FLOPs of ``LMModel.apply`` on a smoke dense config (``impl``
  "dense", fp32) equal the reference's ``compute_costs`` of the jitted
  ``apply``'s compiled HLO within 1 % (the port counts the eager ATen
  matmuls, the reference the HLO dots; a failure lists both sides' ops).
* A pallas serve-smoke model's paged and contiguous decode steps and
  prefill chunks walk to the same FLOPs, traffic, launches, op count and
  peak on the CPU (where the wrappers run their plain versions) and on
  the meta device (where the walk runs them itself); each sparse layer
  launches each kernel once, priced by ``kernel_traffic``'s shape-only
  mode.
* A kernel's call alone: its plain version's ops are not counted — the
  walk of ``ops.flash_attention`` / ``ops.block_sparse_attention`` is
  exactly the shape-only price and no op.
* ``peak_live_bytes`` on a small hand-computed program with views, an
  in-place op, a freed temporary and an autograd graph's saved tensors,
  on the CPU and the meta device, and with ``logsumexp``'s temporary the
  size of its input (allocated inside the op, where no dispatch mode
  sees it); per-op traffic and FLOP rules; no collective on one
  device."""

import dataclasses
import sys

import pytest
import torch

from repro_torch.analysis import kernel_traffic as kt
from repro_torch.analysis.op_costs import ALLOC_BLOCK, compute_costs, meta_like
from repro_torch.configs.registry import get_serve_config, get_smoke_config
from repro_torch.kernels import _build, ops
from repro_torch.models import LMModel
from tests._torch_port import jax_model_config


def _blocks(n):
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def test_apply_flops_match_the_reference_hlo():
    import jax
    import jax.numpy as jnp

    from repro.analysis.hlo_costs import parse_hlo, compute_costs as hlo
    from repro.models import LMModel as JaxLMModel

    cfg = get_smoke_config("qwen3-14b")
    cfg = dataclasses.replace(cfg, dtype="float32",
                              energon=dataclasses.replace(cfg.energon,
                                                          impl="dense"))
    model = LMModel(cfg, device="meta")
    batch = {"inputs": torch.empty((2, 64), dtype=torch.int32,
                                   device="meta")}
    got = compute_costs(model.apply, model.init(), batch)

    jm = JaxLMModel(jax_model_config(cfg))
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    text = jax.jit(jm.apply).lower(
        params, {"inputs": jax.ShapeDtypeStruct((2, 64), jnp.int32)}
    ).compile().as_text()
    want = hlo(text).flops
    dots = sorted(
        (i.opcode, i.shape) for c in parse_hlo(text).values()
        for i in c.instructions if i.opcode in ("dot", "convolution"))
    assert abs(got.flops - want) <= 0.01 * want, (
        f"port {got.flops:.6e} FLOPs by op {got.flops_by_op}; reference "
        f"{want:.6e} over the HLO's {dots}")


MAX_LEN, PAGES = 64, 12


@pytest.fixture(scope="module")
def serve_smoke():
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_torch_graph import _filled

    cfg = get_serve_config("qwen3-14b", smoke=True)
    model = LMModel(cfg, device="cpu")
    params = model.init(seed=0)
    return cfg, model, params, _filled


SPARSE = {True: ("mpmrf_paged_filter_scores", "paged_decode_gather_attention",
                 "mpmrf_paged_prefill_filter_scores",
                 "paged_prefill_gather_attention"),
          False: ("mpmrf_decode_filter_scores", "decode_gather_attention",
                  "mpmrf_prefill_filter_scores", "prefill_gather_attention")}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_serve_steps_walk_the_same_on_cpu_and_meta(serve_smoke, paged):
    cfg, model, params, filled = serve_smoke
    assert cfg.energon.impl == "pallas"
    cache, pre, zero, dec, index = filled(model, params, paged)
    meta = LMModel(cfg, device="meta")
    slots = dec["tokens"].shape[0]
    mcache = (meta.init_paged_cache(PAGES, max_len=MAX_LEN) if paged
              else meta.init_cache(slots, MAX_LEN))
    sparse = cfg.num_layers - cfg.energon.min_prune_layer
    names = SPARSE[paged]
    for method, inputs, idx, kernels in (
            ("decode_step", dec, index, names[:2]),
            ("prefill", pre, zero, names[2:])):
        before = dict(_build.launch_counts)
        on_cpu = compute_costs(getattr(model, method), params, cache, inputs,
                               idx)
        assert _build.launch_counts == before     # the CPU launches nothing
        assert _build.cost_hook is None
        mp, mi, mx = meta_like((params, inputs, idx))
        on_meta = compute_costs(getattr(meta, method), mp, mcache, mi, mx)
        for field in ("flops", "traffic_bytes", "peak_live_bytes",
                      "num_ops", "flops_by_op", "launches",
                      "collective_bytes", "output_bytes"):
            assert getattr(on_cpu, field) == getattr(on_meta, field), (
                method, field)
        assert on_cpu.launches == {k: sparse for k in kernels}
        assert on_cpu.total_collective_bytes == 0
        for name in kernels:
            k = on_cpu.kernels[name]
            assert k.ops == on_cpu.flops_by_op[name] and k.ops > 0
            assert k.bound_ms > 0 and k.bytes > 0


def _flash_case(seed=0, bh=3, n=64, d=16):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen) for _ in range(3)]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_kernel_call_is_its_shape_only_price_and_no_op(device):
    q, k, v = (x.to(device) for x in _flash_case())
    c = compute_costs(ops.flash_attention, q, k, v, block_q=32, block_k=32)
    nbytes, flops, _ = kt.flash(3, 64, 64, 16, itemsize=4)
    assert (c.num_ops, c.flops, c.traffic_bytes) == (0, flops, nbytes)
    assert c.launches == {"flash_attention": 1}
    assert c.peak_live_bytes == _blocks(q.numel() * 4)    # its output only

    idx = torch.tensor([[[0, 1]], [[1, 0]], [[0, 0]]], dtype=torch.int32)
    idx = idx.expand(3, 2, 2).contiguous().to(device)
    val = torch.ones_like(idx)
    c = compute_costs(ops.block_sparse_attention, q, k, v, idx, val,
                      query_block=32, key_block=32)
    nbytes, flops, _ = kt.block_sparse(3, 64, 16, 32, 32, 2, itemsize=4)
    assert (c.num_ops, c.flops, c.traffic_bytes) == (0, flops, nbytes)
    assert c.launches == {"block_sparse_attention": 1}


def test_the_plain_versions_ops_would_have_counted():
    # the same plain version outside the hook: matmuls, many ops
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _flash_case()
    c = compute_costs(fa.flash_attention_plain, q, k, v)
    assert c.num_ops > 3 and c.flops_by_op.get("bmm", 0) > 0
    assert c.launches == {}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_peak_live_bytes_by_hand(device):
    x = torch.ones(1000, device=device)            # an argument: not counted

    def program(x):
        a = x * 2                                  # 4000 → 4096
        b = a.view(10, 100)                        # a view: nothing
        c = a + 1                                  # 4096 + 4096 = 8192
        del a                                      # b keeps a's storage
        d = b * 3                                  # 12288
        del b                                      # a's storage freed: 8192
        c.add_(1)                                  # in place: nothing
        x.mul_(1)                                  # the argument's: nothing
        e = c.sum()                                # + 512 = 8704
        del c, d                                   # 512
        f = torch.ones(2000, device=x.device)      # + 8000 → 8192 = 8704
        g = f[::2].clone()                         # + 4000 → 4096 = 12800
        return e, g

    c = compute_costs(program, x)
    assert c.peak_live_bytes == 12800
    assert c.output_bytes == 4 + 4000


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_logsumexp_counts_its_hidden_temporary(device):
    x = torch.ones(10, 100, device=device)

    def program(x):
        y = x * 1                                  # 4000 → 4096
        return torch.logsumexp(y, dim=-1)          # + 512, + 4096 inside

    assert compute_costs(program, x).peak_live_bytes == 4096 + 512 + 4096


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_saved_tensor_stays_live(device):
    w = torch.ones(1024, device=device, requires_grad=True)

    def program(w, keep):
        h = torch.ones(1024, device=w.device)      # 4096
        y = h * w if keep else h * w.detach()      # + 4096: mul saves h
        del h                                      # freed unless saved
        z = torch.ones(2048, device=w.device)      # + 8192
        return y, z

    assert compute_costs(program, w, True).peak_live_bytes == 16384
    assert compute_costs(program, w, False).peak_live_bytes == 12288


def test_traffic_flop_and_collective_rules():
    a = torch.ones(8, 16)
    b = torch.ones(16, 4)
    c = compute_costs(lambda: torch.mm(a, b))
    assert (c.flops, c.traffic_bytes, c.num_ops) == (
        2 * 8 * 4 * 16, (8 * 16 + 16 * 4 + 8 * 4) * 4, 1)
    c = compute_costs(lambda: a.view(16, 8).t().unsqueeze(0).clone())
    assert (c.num_ops, c.traffic_bytes) == (1, 2 * 8 * 16 * 4)
    c = compute_costs(lambda: torch.empty(1 << 20))
    assert (c.num_ops, c.traffic_bytes) == (0, 0)
    x = torch.ones(2, 6, 10)
    wc = torch.ones(6, 1, 4)                         # depthwise, 4 taps
    c = compute_costs(lambda: torch.nn.functional.conv1d(x, wc, groups=6))
    assert c.flops == 2 * (2 * 6 * 7) * 1 * 4
    c = compute_costs(lambda: torch.baddbmm(torch.ones(3, 8, 4),
                                            torch.ones(3, 8, 16),
                                            torch.ones(3, 16, 4)))
    assert c.flops == 2 * 3 * 8 * 4 * 16
    c = compute_costs(lambda: a.to("meta"))          # a host-side move
    assert c.total_collective_bytes == 0 and c.collective_ops == []


def test_one_walk_at_a_time():
    def nested():
        compute_costs(lambda: torch.ones(2) + 1)

    with pytest.raises(RuntimeError, match="already running"):
        compute_costs(nested)
    assert _build.cost_hook is None

"""The port's analysis modules against the reference's, on the CPU:
``configs`` (the shape matrix), ``core/performance_model``,
``analysis/{flops,memory_model,roofline,kernel_traffic}``.

* ``param_counts`` equals ``repro.analysis.param_counts`` bucket for
  bucket, exactly, for every registered arch at full size (the
  reference counts under ``jax.eval_shape``, the port on the meta
  device).
* ``model_flops`` and ``hbm_traffic_bytes`` equal the reference's for
  every (arch, shape) of ``shapes_for_arch``, at (chips, model shards,
  microbatches) (1, 1, 1) and (256, 16, 8). Both sides count the
  parameters once per arch here (the parity above holds them equal), so
  the matrix runs in seconds.
* The paper's §IV-D functions and ``mpmrf_attention_flops/bytes`` equal
  the reference's on a grid of (d, n, l, β, γ, hw); ``gpu_attention_times``
  and ``build_report`` equal the reference's formulas with the H100's
  data-sheet constants put in place of the TPU's, here in the test.
* ``kernel_traffic``: the shape-only mode gives ``PERF.md``'s
  data-independent bounds (B9 0.0869 / B11 0.1738 ms at bh 160, n 2048,
  d 128; B9 0.6946 / B11 1.3898 ms at bh 80, n 8192); the data mode
  equals the inline formulas ``chip_smoke.py`` bounded each kernel with
  (kept below as the oracle) on random shapes and data; the fused
  prefill breakdown's glue fields equal the reference's.

Everything here is integer or float arithmetic on the same numbers in
the same order, so the comparisons are exact."""

import dataclasses
import functools
import itertools
import math

import pytest
import torch

from repro_torch.analysis import flops as port_flops
from repro_torch.analysis import kernel_traffic as kt
from repro_torch.analysis import memory_model as port_mm
from repro_torch.analysis import roofline as port_roofline
from repro_torch.configs import base as port_base
from repro_torch.configs import registry as port_registry
from repro_torch.core import performance_model as port_pm

ARCHS = port_registry.ARCH_NAMES
H100 = dict(bf16=989e12, int8=1979e12, hbm=3.35e12, nvlink=450e9)


def _ref_config(arch):
    from repro.configs.registry import get_config

    return get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch):
    from repro.analysis import param_counts

    assert port_flops.param_counts(port_registry.get_config(arch)) == \
        param_counts(_ref_config(arch))


@pytest.fixture
def counted_once(monkeypatch):
    """Both packages' ``param_counts`` cached per config."""
    import repro.analysis.flops as ref_flops
    import repro.analysis.memory_model as ref_mm

    ref = functools.lru_cache(None)(ref_flops.param_counts)
    port = functools.lru_cache(None)(port_flops.param_counts)
    monkeypatch.setattr(ref_flops, "param_counts", ref)
    monkeypatch.setattr(ref_mm, "param_counts", ref)
    monkeypatch.setattr(port_flops, "param_counts", port)
    monkeypatch.setattr(port_mm, "param_counts", port)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_hbm_traffic_equal_the_reference(arch,
                                                         counted_once):
    from repro.analysis.flops import model_flops
    from repro.analysis.memory_model import hbm_traffic_bytes
    from repro.configs import shapes_for_arch

    ref_cfg, cfg = _ref_config(arch), port_registry.get_config(arch)
    ref_shapes = shapes_for_arch(arch)
    shapes = port_base.shapes_for_arch(arch)
    assert [dataclasses.astuple(s) for s in shapes] == \
        [dataclasses.astuple(s) for s in ref_shapes]
    for shape, ref_shape in zip(shapes, ref_shapes):
        assert port_flops.model_flops(cfg, shape) == \
            model_flops(ref_cfg, ref_shape)
        for chips, shards, mb in ((1, 1, 1), (256, 16, 8)):
            for factored in (False, True):
                assert port_mm.hbm_traffic_bytes(
                    cfg, shape, chips, shards, mb, opt_factored=factored
                ) == hbm_traffic_bytes(ref_cfg, ref_shape, chips, shards,
                                       mb, opt_factored=factored)


def test_shape_matrix_equals_the_reference():
    import repro.configs.base as ref_base

    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.astuple(getattr(port_base, name)) == \
            dataclasses.astuple(getattr(ref_base, name))
    assert port_base.LONG_CONTEXT_ARCHS == ref_base.LONG_CONTEXT_ARCHS
    assert [s.is_decode for s in port_base.ALL_SHAPES] == \
        [s.is_decode for s in ref_base.ALL_SHAPES]
    for arch in ARCHS:
        assert port_registry.get_config(arch).attention_free == \
            _ref_config(arch).attention_free


# ---------------------------------------------------------------------------
# core/performance_model.py
# ---------------------------------------------------------------------------

GRID = list(itertools.product((64, 128), (512, 4096), (1, 128),
                              (0.25, 0.5), (0.3, 0.5), ("edge", "server")))


def test_paper_model_equals_the_reference():
    from repro.core import performance_model as ref

    hws = {"edge": (ref.ENERGON_EDGE, port_pm.ENERGON_EDGE),
           "server": (ref.ENERGON_SERVER, port_pm.ENERGON_SERVER)}
    for rh, ph in hws.values():
        assert dataclasses.astuple(rh) == dataclasses.astuple(ph)
    for d, n, l, beta, gamma, hw in GRID:
        rh, ph = hws[hw]
        assert port_pm.load_cycles(d, n, ph) == ref.load_cycles(d, n, rh)
        assert port_pm.attention_cycles(beta, n, l, ph) == \
            ref.attention_cycles(beta, n, l, rh)
        assert port_pm.filter_cycles(gamma, n, l, ph) == \
            ref.filter_cycles(gamma, n, l, rh)
        assert port_pm.load_to_compute_ratio(d, n, l, beta, ph) == \
            ref.load_to_compute_ratio(d, n, l, beta, rh)
        assert port_pm.should_double_buffer(d, n, l, beta, ph) == \
            ref.should_double_buffer(d, n, l, beta, rh)
        assert port_pm.balanced_fu_parallelism(ph.mac_parallelism, beta,
                                               gamma) == \
            ref.balanced_fu_parallelism(rh.mac_parallelism, beta, gamma)
        for db in (True, False):
            assert port_pm.head_latency_cycles(d, n, l, beta, gamma, ph,
                                               db) == \
                ref.head_latency_cycles(d, n, l, beta, gamma, rh, db)
        kw = dict(batch=2, heads=8, q_len=l, kv_len=n, head_dim=d,
                  pruning_ratio=1 / beta, round0_survivor=gamma)
        rw, pw = ref.AttentionWorkload(**kw), port_pm.AttentionWorkload(**kw)
        assert port_pm.mpmrf_attention_flops(pw) == \
            ref.mpmrf_attention_flops(rw)
        assert port_pm.mpmrf_attention_bytes(pw) == \
            ref.mpmrf_attention_bytes(rw)


def test_h100_constants_and_gpu_attention_times():
    from repro.core import performance_model as ref

    assert (port_pm.H100_PEAK_FLOPS_BF16, port_pm.H100_PEAK_OPS_INT8,
            port_pm.H100_HBM_BW, port_pm.H100_NVLINK_BW) == \
        (H100["bf16"], H100["int8"], H100["hbm"], H100["nvlink"])
    for d, n, l, beta, gamma, _ in GRID:
        kw = dict(batch=2, heads=8, q_len=l, kv_len=n, head_dim=d,
                  pruning_ratio=1 / beta, round0_survivor=gamma)
        w = ref.AttentionWorkload(**kw)
        f, b = ref.mpmrf_attention_flops(w), ref.mpmrf_attention_bytes(w)
        # tpu_attention_times' body, the H100's rates in the TPU's place
        t_filter = max(f["filter"] / H100["int8"], b["filter"] / H100["hbm"])
        t_attend = max(f["attend"] / H100["bf16"], b["attend"] / H100["hbm"])
        t_dense = max(f["dense"] / H100["bf16"], b["dense"] / H100["hbm"])
        want = {
            "t_filter": t_filter, "t_attend": t_attend,
            "t_mpmrf": t_filter + t_attend, "t_dense": t_dense,
            "speedup": t_dense / max(t_filter + t_attend, 1e-30),
            "compute_bound": (f["attend"] / H100["bf16"])
            > (b["attend"] / H100["hbm"]),
        }
        got = port_pm.gpu_attention_times(port_pm.AttentionWorkload(**kw))
        assert got == want
        assert set(got) == set(ref.tpu_attention_times(w))


@pytest.mark.parametrize("traffic", [None, 7.5e11])
def test_build_report_equals_the_reference_formulas(traffic):
    from repro.analysis import build_report

    kw = dict(arch="qwen3-14b", shape="train_4k", mesh_name="1x1", chips=1,
              parsed_flops=3.2e15, parsed_traffic_bytes=4.1e12,
              parsed_collective_bytes={"copy": 2.0e9, "all-gather": 1e9},
              model_flops=2.9e15, raw_flops=1.0, raw_bytes=2.0,
              peak_memory_bytes=7e10, analytic_traffic_bytes=traffic)
    got = port_roofline.build_report(**kw).to_dict()
    ref = build_report(**kw).to_dict()
    mem = (traffic if traffic is not None else 4.1e12) / H100["hbm"]
    terms = {"compute": 3.2e15 / H100["bf16"], "memory": mem,
             "collective": 3.0e9 / H100["nvlink"]}
    want = dict(ref, compute_s=terms["compute"], memory_s=terms["memory"],
                collective_s=terms["collective"],
                dominant=max(terms, key=terms.get),
                bound_time_s=max(terms.values()),
                roofline_fraction=2.9e15 / 1 / H100["bf16"]
                / max(terms.values()))
    assert got == want
    assert set(got) == set(ref)


# ---------------------------------------------------------------------------
# analysis/kernel_traffic.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bh, n, b9, b11", [(160, 2048, 0.0869, 0.1738),
                                            (80, 8192, 0.6946, 1.3898)])
def test_shape_only_bounds_are_perf_mds(bh, n, b9, b11):
    ms9, by9 = kt.bound_ms(*kt.sequence_filter(bh, n, n, 128, 128, 64))
    ms11, by11 = kt.bound_ms(*kt.flash(bh, n, n, 128))
    assert (round(ms9, 4), by9) == (b9, "operations")
    assert (round(ms11, 4), by11) == (b11, "operations")


def _paged_case(gen, bh, g, d, bk, mb, n_q, bq, budget):
    """Random operands of B1–B4 at their wrappers' shapes and dtypes."""
    n_k = mb * bk
    case = dict(
        qp=torch.randint(-8, 8, (bh, g, d), generator=gen, dtype=torch.int32),
        qs=torch.rand((bh, g, 1), generator=gen),
        bt=torch.randint(0, 4 * mb, (bh, mb), generator=gen,
                         dtype=torch.int32),
        cl=torch.randint(1, n_k + 1, (bh,), generator=gen, dtype=torch.int32),
        q_dec=torch.randn((bh, g, d), generator=gen).to(torch.bfloat16),
        idx=torch.randint(0, mb, (bh, budget), generator=gen,
                          dtype=torch.int32),
        val=torch.randint(0, 2, (bh, budget), generator=gen,
                          dtype=torch.int32),
        qpp=torch.randint(-8, 8, (bh, n_q, d), generator=gen,
                          dtype=torch.int32),
        qps=torch.rand((bh, n_q, 1), generator=gen),
        q_pre=torch.randn((bh, n_q, d), generator=gen).to(torch.bfloat16),
        pidx=torch.randint(0, mb, (bh, n_q // bq, budget), generator=gen,
                           dtype=torch.int32),
        pval=torch.randint(0, 2, (bh, n_q // bq, budget), generator=gen,
                           dtype=torch.int32),
    )
    qpos = torch.randint(0, n_k, (bh, n_q), generator=gen, dtype=torch.int32)
    qpos[0, -3:] = n_k                            # sentinel rows
    qpos[1] = n_k                                 # an all-sentinel row
    case["qpos"] = qpos
    case["s0"] = torch.zeros((bh, mb))
    case["p0"] = torch.zeros((bh, n_q // bq, mb))
    return case


def _inline_paged(c, *, g, d, bk, bq):
    """``chip_smoke.py``'s inline bytes / operations of B1–B4 (its
    ``check_case`` before the counts moved into ``kernel_traffic``)."""
    n_k = c["bt"].shape[-1] * bk
    live_blocks = int(((c["cl"].long() + bk - 1) // bk).sum())
    b1_bytes = (c["qp"].numel() * 4 + c["qs"].numel() * 4
                + c["bt"].numel() * 4 + c["cl"].numel() * 4
                + live_blocks * bk * d * 2 + live_blocks * 4
                + 2 * c["s0"].numel() * 4)
    b1_ops = live_blocks * g * bk * d * 2 * 2
    n_valid = int(c["val"].sum())
    b2_bytes = (c["q_dec"].numel() * 2 + 3 * c["idx"].numel() * 4
                + c["cl"].numel() * 4 + n_valid * bk * d * 2 * 2
                + c["q_dec"].numel() * 2)
    b2_flops = n_valid * g * bk * d * 2 * 2
    valid_rows = c["qpos"] < n_k
    pairs = int(torch.where(valid_rows, c["qpos"].long() + 1, 0).sum())
    seen = torch.where(valid_rows, c["qpos"], -1).amax(dim=1)
    seen_pages = int(((seen.long() + bk) // bk).clamp(min=0).sum())
    b3_bytes = (c["qpp"].numel() * 4 + c["qps"].numel() * 4
                + c["qpos"].numel() * 4 + c["bt"].numel() * 4
                + seen_pages * (bk * d * 2 + 4) + 2 * c["p0"].numel() * 4)
    b3_ops = pairs * d * 2 * 2
    n_pvalid = int(c["pval"].sum())
    n_qb = c["q_pre"].shape[1] // bq
    ppages = torch.gather(c["bt"].long()[:, None, :].expand(-1, n_qb, -1),
                          2, c["pidx"].long())
    b4_bytes = (c["q_pre"].numel() * 2 * 2 + c["qpos"].numel() * 4
                + 2 * c["pidx"].numel() * 4
                + int(torch.unique(ppages[c["pval"] > 0]).numel())
                * bk * d * 2 * 2)
    b4_flops = n_pvalid * bq * bk * d * 2 * 2
    return ((b1_bytes, b1_ops), (b2_bytes, b2_flops), (b3_bytes, b3_ops),
            (b4_bytes, b4_flops))


def _inline_contiguous(c, *, g, d, bk, pk, bq):
    """``chip_smoke.py``'s inline bytes / operations of B5–B8 (its
    ``check_contiguous``), on a B1–B4 case read as the contiguous cache
    (``bt``'s width as its blocks of ``bk``)."""
    n_k = c["bt"].shape[-1] * bk
    n_kb = n_k // bk
    live_blocks = int(((c["cl"].long() + bk - 1) // bk).clamp(
        max=n_kb).sum())
    s0 = torch.zeros((c["qp"].shape[0], n_kb))
    b5_bytes = (c["qp"].numel() * 4 + c["qs"].numel() * 4
                + c["cl"].numel() * 4 + live_blocks * (bk * d * 2 + 4)
                + 2 * s0.numel() * 4)
    b5_ops = live_blocks * g * bk * d * 2 * 2
    n_valid = int(c["val"].sum())
    b6_bytes = (c["q_dec"].numel() * 2 * 2 + 2 * c["idx"].numel() * 4
                + c["cl"].numel() * 4 + n_valid * bk * d * 2 * 2)
    b6_flops = n_valid * g * bk * d * 2 * 2
    valid_rows = c["qpos"] < n_k
    pairs = int(torch.where(valid_rows, c["qpos"].long() + 1, 0).sum())
    seen = torch.where(valid_rows, c["qpos"], -1).amax(dim=1)
    seen_blocks = int(((seen.long() + pk) // pk).clamp(min=0).sum())
    p0 = torch.zeros((c["qp"].shape[0], c["qpp"].shape[1] // bq, n_k // pk))
    b7_bytes = (c["qpp"].numel() * 4 + c["qps"].numel() * 4
                + c["qpos"].numel() * 4 + seen_blocks * pk * (d * 2 + 4)
                + 2 * p0.numel() * 4)
    b7_ops = pairs * d * 2 * 2
    n_pvalid = int(c["pval"].sum())
    ids = kt.row_blocks(c["pidx"], n_k // pk)
    b8_bytes = (c["q_pre"].numel() * 2 * 2 + c["qpos"].numel() * 4
                + 2 * c["pidx"].numel() * 4
                + int(torch.unique(ids[c["pval"] > 0]).numel())
                * pk * d * 2 * 2)
    b8_flops = n_pvalid * bq * pk * d * 2 * 2
    return ((b5_bytes, b5_ops), (b6_bytes, b6_flops), (b7_bytes, b7_ops),
            (b8_bytes, b8_flops))


@pytest.mark.parametrize("seed", range(4))
def test_data_mode_equals_the_inline_serving_counts(seed):
    gen = torch.Generator().manual_seed(seed)
    bh, g, d, bk, mb, bq = (int(x) for x in (
        torch.randint(2, 9, (1,), generator=gen),
        torch.randint(1, 9, (1,), generator=gen), 16 * (1 + seed % 4),
        (16, 64)[seed % 2], torch.randint(2, 12, (1,), generator=gen), 32))
    n_q, budget = 2 * bq, max(1, mb // 4)
    c = _paged_case(gen, bh, g, d, bk, mb, n_q, bq, budget)
    n_k = mb * bk
    b1, b2, b3, b4 = _inline_paged(c, g=g, d=d, bk=bk, bq=bq)
    assert kt.decode_filter(
        bh, g, d, bk, mb, paged=True,
        live_blocks=kt.live_block_count(c["cl"], bk))[:2] == b1
    assert kt.decode_gather(
        bh, g, d, bk, budget, paged=True,
        valid_slots=int(c["val"].sum()))[:2] == b2
    assert kt.prefill_filter(
        bh, n_q, d, bq, bk, mb, paged=True,
        seen_blocks=kt.seen_block_count(c["qpos"], bk, n_k),
        pairs=kt.row_pair_count(c["qpos"], n_k))[:2] == b3
    pages = torch.gather(c["bt"].long()[:, None, :].expand(-1, n_q // bq, -1),
                         2, c["pidx"].long())
    assert kt.prefill_gather(
        bh, n_q, d, bq, bk, budget,
        distinct_blocks=kt.distinct_block_count(pages, c["pval"]),
        valid_slots=int(c["pval"].sum()))[:2] == b4

    pk = bk * (1 + seed % 2)
    b5, b6, b7, b8 = _inline_contiguous(c, g=g, d=d, bk=bk, pk=pk, bq=bq)
    assert kt.decode_filter(
        bh, g, d, bk, n_k // bk, paged=False,
        live_blocks=kt.live_block_count(c["cl"], bk, n_k // bk))[:2] == b5
    assert kt.decode_gather(
        bh, g, d, bk, budget, paged=False,
        valid_slots=int(c["val"].sum()))[:2] == b6
    assert kt.prefill_filter(
        bh, n_q, d, bq, pk, n_k // pk, paged=False,
        seen_blocks=kt.seen_block_count(c["qpos"], pk, n_k),
        pairs=kt.row_pair_count(c["qpos"], n_k))[:2] == b7
    assert kt.prefill_gather(
        bh, n_q, d, bq, pk, budget,
        distinct_blocks=kt.distinct_block_count(
            kt.row_blocks(c["pidx"], n_k // pk), c["pval"]),
        valid_slots=int(c["pval"].sum()))[:2] == b8


def _inline_full_sequence(q, k, v, qs, s0, idx, val, *, bq, bk, q_offset):
    """``chip_smoke.py``'s inline bytes / operations of B9–B11 (its
    ``check_full_sequence``; its timed calls all had n_q = n_k)."""
    bh, n_q, d = q.shape
    n_k = k.shape[1]
    n_kb = n_k // bk
    rows = torch.arange(n_q) + q_offset
    pairs = int(torch.clamp(rows + 1, 0, n_k).sum()) * bh
    b9_bytes = 3 * q.numel() + qs.numel() * 4 + 2 * s0.numel() * 4
    b9_ops = pairs * d * 2 * 2
    blocks = (torch.arange(bh).reshape(-1, 1, 1) * n_kb + idx.long())
    b10_bytes = (q.numel() * 2 * 2 + 2 * idx.numel() * 4
                 + int(torch.unique(blocks[val > 0]).numel())
                 * bk * d * 2 * 2)
    n_qb = idx.shape[1]
    qpos = (q_offset + torch.arange(n_qb)[:, None] * bq + torch.arange(bq))
    seen = torch.clamp(qpos[None, :, None, :] - idx.long()[..., None] * bk
                       + 1, 0, bk)
    b10_flops = int((seen.sum(-1) * val).sum()) * d * 2 * 2
    b11_bytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2
    b11_flops = pairs * d * 2 * 2
    return ((b9_bytes, b9_ops), (b10_bytes, b10_flops),
            (b11_bytes, b11_flops))


@pytest.mark.parametrize("seed", range(4))
def test_data_mode_equals_the_inline_full_sequence_counts(seed):
    gen = torch.Generator().manual_seed(100 + seed)
    bh, d = 3 + seed, 16 * (1 + seed % 4)
    bq, bk = (32, 16) if seed % 2 else (64, 64)
    n = 4 * max(bq, bk)
    q_offset = (0, 0, 16, 64)[seed]
    n_qb, n_kb = n // bq, n // bk
    budget = max(1, n_kb // 2)
    q, k, v = (torch.randn((bh, n, d), generator=gen).to(torch.bfloat16)
               for _ in range(3))
    qs = torch.rand((bh, n, 1), generator=gen)
    s0 = torch.zeros((bh, n_qb, n_kb))
    idx = torch.randint(0, n_kb, (bh, n_qb, budget), generator=gen,
                        dtype=torch.int32)
    val = torch.randint(0, 2, (bh, n_qb, budget), generator=gen,
                        dtype=torch.int32)
    b9, b10, b11 = _inline_full_sequence(q, k, v, qs, s0, idx, val, bq=bq,
                                         bk=bk, q_offset=q_offset)
    assert kt.sequence_filter(bh, n, n, d, bq, bk,
                              q_offset=q_offset)[:2] == b9
    assert kt.block_sparse(
        bh, n, d, bq, bk, budget,
        distinct_blocks=kt.distinct_block_count(kt.row_blocks(idx, n_kb),
                                                val),
        survivor_pairs=kt.survivor_pair_count(idx, val, bq, bk, q_offset),
    )[:2] == b10
    assert kt.flash(bh, n, n, d, q_offset=q_offset)[:2] == b11


def test_shape_only_mode_counts_every_slot_and_block():
    # every block below the length live, every slot valid, each read anew
    full = _paged_case(torch.Generator().manual_seed(0), 4, 2, 32, 16, 6,
                       64, 32, 3)
    full["cl"].fill_(6 * 16)
    full["val"].fill_(1)
    b1 = _inline_paged(full, g=2, d=32, bk=16, bq=32)[0]
    assert kt.decode_filter(4, 2, 32, 16, 6, paged=True)[:2] == b1
    assert kt.decode_gather(4, 2, 32, 16, 3, paged=True)[:2] == (
        2 * 4 * 2 * 32 * 2 + 3 * 4 * 3 * 4 + 4 * 4 + 12 * 16 * 32 * 4,
        12 * 2 * 16 * 32 * 4)
    nbytes, ops, _ = kt.prefill_filter(4, 64, 32, 32, 16, 6, paged=False)
    assert ops == 4 * 64 * 6 * 16 * 32 * 4
    assert kt.block_sparse(2, 64, 16, 32, 16, 2)[:2] == (
        2 * 2 * 64 * 16 * 2 + 2 * 8 * 4 + 8 * 16 * 16 * 2 * 2,
        8 * 32 * 16 * 16 * 4)
    assert nbytes > 0


@pytest.mark.parametrize("shape", [
    dict(bh=16, n_q=256, n_k=2048, d=128, query_block=128, key_block=64,
         filter_block=64, block_budget=8),
    dict(bh=3, n_q=64, n_k=512, d=64, query_block=32, key_block=128,
         filter_block=64, block_budget=2),
])
def test_fused_prefill_glue_equals_the_reference(shape):
    from repro.analysis.kernel_traffic import fused_prefill_traffic

    ref = fused_prefill_traffic(**shape)
    got = kt.fused_prefill_traffic(**shape)
    assert (got.quantize_bytes, got.select_bytes) == \
        (ref.quantize_bytes, ref.select_bytes)
    # the filter streams the same tiles as the reference's BlockSpecs;
    # the gather moves bf16 where the reference moves f32
    assert got.filter_bytes == ref.filter_bytes
    n_qb = shape["n_q"] // shape["query_block"]
    budget = min(shape["block_budget"], shape["n_k"] // shape["key_block"])
    assert got.gather_bytes == kt.prefill_gather(
        shape["bh"], shape["n_q"], shape["d"], shape["query_block"],
        shape["key_block"], budget)[0]
    assert got.gather_bytes < ref.gather_bytes
    assert got.total_bytes == (got.quantize_bytes + got.filter_bytes
                               + got.select_bytes + got.gather_bytes)
    assert n_qb * budget > 0 and math.isfinite(got.total_bytes)
    with pytest.raises(ValueError, match="tile sizes"):
        kt.fused_prefill_traffic(**dict(shape, n_q=shape["n_q"] + 1))

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

Run from the repository root: ``python3 chip_smoke.py`` (``--layers N``
cuts qwen3-14b's depth, never its width). Phases:

1. The card's name and power limit, torch/CUDA versions, and the
   ``nvcc`` build of every kernel from ``src/repro_torch/kernels/csrc``.
2. Each kernel of the serving path (B1–B4) at the path's shapes on
   random inputs, held against its plain PyTorch version on the card:
   filter scores (B1, B3) and the selection made from them must be
   bit-equal; the bf16 gathers (B2, B4) must agree within
   |Δ| ≤ 1e-3 + 1.6e-2·|ref| (two bf16 ulps: both sides compute in f32
   from the same bf16 inputs and round the output once, so they differ
   by one ulp at most; ``repro_torch.kernels.gather_within_tolerance``).
   Then each kernel, its plain version and one PyTorch call computing
   the same function where one exists (SDPA over the gathered
   survivors, timed only) are timed with CUDA events.
3. A small reference check: the serve-smoke model in bf16, prefill and
   decode logits with the kernels against the same model with the
   plain versions swapped in, on the same card (only layer 2 is sparse
   there, and its selection is bit-exact, so the logits differ by the
   gathers' rounding alone, amplified by the bf16 layers above it):
   ‖Δ‖/‖ref‖ ≤ 2.5e-3. ``tests/test_torch_smoke.py`` runs this check on
   the CPU: every gather output one ulp off passes, a softmax scale off
   by 10 % or a mask admitting one more key fails. Faults smaller than
   that are phase 2's to catch.
4. Serving qwen3-14b at full width (random weights from a seed) through
   ``ServeLoop``: 8 requests of 2048-token prompts sharing a 256-token
   system prompt, 32 greedy tokens each, 8 slots, max_len 4096,
   prefill chunk 128. Launch counts are zeroed just before this run and
   read just after; every kernel must have launched, every request
   drained and every logit been finite. The same requests are served
   again (now hitting the prefix cache) and must give the same streams.
5. The kernels again, compared and timed on the live pool of a sparse
   layer after serving.
6. One more drain of fresh prompts on the same engine under
   ``torch.profiler``: the share of the wall time the device was busy
   and the largest device items.

The line before last is a JSON object listing each kernel's launches,
error and times (those of the live pool; ``random`` holds phase 2's);
the last line is ``{"ok": true, "device": ...}``.
Any failure exits non-zero before printing either.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

H100_BYTES_PER_S = 3.35e12        # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12          # dense tensor-core peak
H100_INT8_OPS = 1979e12           # dense tensor-core peak
SMALL_REL_TOL = 2.5e-3
SYSTEM_LEN = 256                  # shared system prompt of the serve phase
#: the card the script drives (a CPU rehearsal of its logic may swap it)
DEV = "cuda"

KERNELS = {
    "mpmrf_paged_filter_scores": dict(
        id="B1", source="src/repro_torch/kernels/csrc/mpmrf_decode.cu",
        replaces="src/repro/kernels/mpmrf_decode.py:209"),
    "paged_decode_gather_attention": dict(
        id="B2", source="src/repro_torch/kernels/csrc/mpmrf_decode.cu",
        replaces="src/repro/kernels/mpmrf_decode.py:466"),
    "mpmrf_paged_prefill_filter_scores": dict(
        id="B3", source="src/repro_torch/kernels/csrc/mpmrf_prefill.cu",
        replaces="src/repro/kernels/mpmrf_prefill.py:224"),
    "paged_prefill_gather_attention": dict(
        id="B4", source="src/repro_torch/kernels/csrc/mpmrf_prefill.cu",
        replaces="src/repro/kernels/mpmrf_prefill.py:502"),
}


class SmokeFailure(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def mem_gb(fn) -> str:
    return f"{fn() / 1e9:.1f}" if DEV == "cuda" else "n/a"


def sync():
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    sync()
    if DEV != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# kernel operands at the serving path's shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelCase:
    """Operands of B1–B4 for one decode step and one prefill chunk of a
    sparse layer: ``bh = B·KV`` rows over a pool of ``KV·P`` pages."""

    q_dec: object       # [bh, G, d] bf16
    cl: object          # [bh] int32
    q_pre: object       # [bh, n_q, d] bf16
    qpos: object        # [bh, n_q] int32
    k_pages: object     # [KV·P, bk, d] bf16
    v_pages: object
    codes: object       # [KV·P, bk, d] int16
    scale: object       # [KV·P, 1] f32
    bt: object          # [bh, mb] int32 (head-offset)
    batch: int
    heads: int
    bk: int
    bq: int
    ratio: float


def random_case(gen, *, batch=8, heads=8, g=5, d=128, bk=64, mb=64, chunk=128,
                bq=128, ratio=4.0, seed=0):
    import torch

    from repro_torch.core import quantization as qlib

    dev = DEV
    num_pages = batch * mb
    rows = num_pages * bk
    k = torch.randn((heads, rows, d), generator=gen, device=dev)
    v = torch.randn((heads, rows, d), generator=gen, device=dev)
    codes, scales = qlib.quantize_int16_blocks(k.to(torch.bfloat16), bk)
    perm = torch.randperm(num_pages, generator=gen, device=dev)
    table = perm[: batch * mb].reshape(batch, mb).to(torch.int32)
    cl = torch.randint(1, mb * bk + 1, (batch,), generator=gen, device=dev)
    # one prefill chunk per slot at a random chunk-aligned offset
    off = torch.randint(0, mb * bk // chunk, (batch,), generator=gen,
                        device=dev) * chunk
    pos = off[:, None] + torch.arange(chunk, device=dev)[None, :]
    qpos = pos.repeat(1, g).to(torch.int32)                  # [B, G·C]
    return make_case(
        torch.randn((batch, heads, g, d), generator=gen, device=dev),
        cl.to(torch.int32),
        torch.randn((batch, heads, g * chunk, d), generator=gen, device=dev),
        qpos, k, v, codes, scales, table, bk=bk, bq=bq, ratio=ratio,
    )


def make_case(q_dec, cl, q_pre, qpos, k_pool, v_pool, codes, scales, table,
              *, bk, bq, ratio):
    import torch

    from repro_torch.kernels.ops import _head_offset_table

    batch, heads, g, d = q_dec.shape
    num_pages = k_pool.shape[1] // bk
    return KernelCase(
        q_dec=q_dec.to(torch.bfloat16).reshape(batch * heads, g, d),
        cl=cl.repeat_interleave(heads).to(torch.int32),
        q_pre=q_pre.to(torch.bfloat16).reshape(batch * heads, -1, d),
        qpos=qpos.repeat_interleave(heads, dim=0).to(torch.int32),
        k_pages=k_pool.to(torch.bfloat16).reshape(heads * num_pages, bk, d),
        v_pages=v_pool.to(torch.bfloat16).reshape(heads * num_pages, bk, d),
        codes=codes.reshape(heads * num_pages, bk, d).contiguous(),
        scale=scales.reshape(heads * num_pages, 1).float().contiguous(),
        bt=_head_offset_table(table, heads, num_pages),
        batch=batch, heads=heads, bk=bk, bq=bq, ratio=ratio,
    )


def quantized_q(q):
    from repro_torch.core import quantization as qlib

    q16 = qlib.quantize_int16(q, axis=-1)
    return q16.bit_plane(4).contiguous(), q16.scale.contiguous()


def check_case(case, label, results):
    """Hold B1–B4 against their plain versions on ``case``; time them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.energon_attention import (
        _prefill_diag_blocks, decode_live_budget,
    )
    from repro_torch.kernels import gather_within_tolerance
    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_prefill as pk
    from repro_torch.kernels import ops

    c = case
    bh, g, d = c.q_dec.shape
    mb = c.bt.shape[-1]
    n_k = mb * c.bk
    n_q = c.q_pre.shape[1]
    n_qb = n_q // c.bq
    budget = max(1, math.ceil(mb / c.ratio))

    # --- B1 + decode selection ------------------------------------------
    qp, qs = quantized_q(c.q_dec)
    b1 = lambda: dk.paged_filter_scores(
        qp, qs, c.codes, c.scale, c.bt, c.cl, key_block=c.bk)
    b1p = lambda: dk.paged_filter_scores_plain(
        qp, qs, c.codes, c.scale, c.bt, c.cl, key_block=c.bk)
    s0, s1 = b1()
    r0, r1 = b1p()
    sync()
    need(torch.equal(s0, r0) and torch.equal(s1, r1),
         f"{label} B1 scores differ from the plain version")
    lb = decode_live_budget(c.cl, c.bk, c.ratio)
    sel = dict(alphas=(0.0, 0.0), key_block=c.bk, block_budget=budget,
               keep_all=False, keep_first=True, keep_diagonal=True,
               live_budget=lb, heads=1)
    idx, val, _ = ops._fused_decode_select(s0, s1, c.cl, **sel)
    ridx, rval, _ = ops._fused_decode_select(r0, r1, c.cl, **sel)
    need(torch.equal(idx, ridx) and torch.equal(val, rval),
         f"{label} B1 selection differs")
    results["mpmrf_paged_filter_scores"].append(dict(err=0.0))

    # --- B2 ---------------------------------------------------------------
    b2 = lambda: dk.paged_decode_gather_attention(
        c.q_dec, c.k_pages, c.v_pages, idx, val, c.bt, c.cl, key_block=c.bk)
    b2p = lambda: dk.paged_decode_gather_attention_plain(
        c.q_dec, c.k_pages, c.v_pages, idx, val, c.bt, c.cl, key_block=c.bk)
    out, ref = b2().float(), b2p().float()
    err = (out - ref).abs().max().item()
    need(gather_within_tolerance(out, ref), f"{label} B2 off by {err:.3e}")
    results["paged_decode_gather_attention"].append(
        dict(err=err, ref_rms=ref.pow(2).mean().sqrt().item()))

    # --- B3 + prefill selection -------------------------------------------
    qpp, qps = quantized_q(c.q_pre)
    b3 = lambda: pk.paged_prefill_filter_scores(
        qpp, qps, c.qpos, c.codes, c.scale, c.bt, query_block=c.bq,
        key_block=c.bk)
    b3p = lambda: pk.paged_prefill_filter_scores_plain(
        qpp, qps, c.qpos, c.codes, c.scale, c.bt, query_block=c.bq,
        key_block=c.bk)
    p0, p1 = b3()
    q0, q1 = b3p()
    sync()
    need(torch.equal(p0, q0) and torch.equal(p1, q1),
         f"{label} B3 scores differ from the plain version")
    diag = _prefill_diag_blocks(c.qpos, c.bq, c.bk, n_k)
    psel = dict(round_bits=(2, 4), alphas=(0.0, 0.0), query_block=c.bq,
                key_block=c.bk, block_budget=budget, keep_all=False,
                keep_first=True, keep_diagonal=True, diag_blocks=diag,
                heads=1)
    pidx, pval, _ = ops._fused_prefill_select(p0, p1, **psel)
    ridx2, rval2, _ = ops._fused_prefill_select(q0, q1, **psel)
    need(torch.equal(pidx, ridx2) and torch.equal(pval, rval2),
         f"{label} B3 selection differs")
    results["mpmrf_paged_prefill_filter_scores"].append(dict(err=0.0))

    # --- B4 ---------------------------------------------------------------
    b4 = lambda: pk.paged_prefill_gather_attention(
        c.q_pre, c.qpos, c.k_pages, c.v_pages, pidx, pval, c.bt,
        query_block=c.bq, key_block=c.bk)
    b4p = lambda: pk.paged_prefill_gather_attention_plain(
        c.q_pre, c.qpos, c.k_pages, c.v_pages, pidx, pval, c.bt,
        query_block=c.bq, key_block=c.bk)
    out, ref = b4().float(), b4p().float()
    err = (out - ref).abs().max().item()
    need(gather_within_tolerance(out, ref), f"{label} B4 off by {err:.3e}")
    results["paged_prefill_gather_attention"].append(
        dict(err=err, ref_rms=ref.pow(2).mean().sqrt().item()))
    r2 = results["paged_decode_gather_attention"][-1]
    r4 = results["paged_prefill_gather_attention"][-1]
    log(f"[kernels:{label}] B1/B3 bit-equal (scores and selection); "
        f"B2 max |err| {r2['err']:.3e} (rms |ref| {r2['ref_rms']:.3e}), "
        f"B4 max |err| {r4['err']:.3e} (rms |ref| {r4['ref_rms']:.3e})")

    # --- yardsticks: SDPA over the gathered survivors (timed only) -------
    pages = torch.gather(c.bt.long(), 1, idx.long())
    kg = c.k_pages[pages].reshape(bh, 1, -1, d)
    vg = c.v_pages[pages].reshape(bh, 1, -1, d)
    kpos = (idx.long()[:, :, None] * c.bk
            + torch.arange(c.bk, device=DEV)).reshape(bh, -1)
    okd = ((val[:, :, None] > 0).expand(-1, -1, c.bk).reshape(bh, -1)
           & (kpos < c.cl.long()[:, None]))
    maskd = okd[:, None, None, :].expand(bh, 1, g, okd.shape[-1])
    qd = c.q_dec.reshape(bh, 1, g, d)
    sdpa_dec = lambda: F.scaled_dot_product_attention(qd, kg, vg,
                                                      attn_mask=maskd)
    ppages = torch.gather(c.bt.long()[:, None, :].expand(-1, n_qb, -1), 2,
                          pidx.long())
    kgp = c.k_pages[ppages].reshape(bh * n_qb, 1, -1, d)
    vgp = c.v_pages[ppages].reshape(bh * n_qb, 1, -1, d)
    kposp = (pidx.long()[..., None] * c.bk
             + torch.arange(c.bk, device=DEV)).reshape(bh, n_qb, 1, -1)
    slot_ok = (pval[..., None] > 0).expand(-1, -1, -1, c.bk).reshape(
        bh, n_qb, 1, -1)
    qposr = c.qpos.long().reshape(bh, n_qb, c.bq, 1)
    maskp = (slot_ok & (kposp <= qposr) & (qposr < n_k)).reshape(
        bh * n_qb, 1, c.bq, -1)
    qpr = c.q_pre.reshape(bh * n_qb, 1, c.bq, d)
    sdpa_pre = lambda: F.scaled_dot_product_attention(qpr, kgp, vgp,
                                                      attn_mask=maskp)

    # --- bounds from this case's data ------------------------------------
    live_blocks = int(((c.cl.long() + c.bk - 1) // c.bk).sum())
    b1_bytes = (qp.numel() * 4 + qs.numel() * 4 + c.bt.numel() * 4
                + c.cl.numel() * 4 + live_blocks * c.bk * d * 2
                + live_blocks * 4 + 2 * s0.numel() * 4)
    b1_ops = live_blocks * g * c.bk * d * 2 * 2
    n_valid = int(val.sum())
    b2_bytes = (c.q_dec.numel() * 2 + 3 * idx.numel() * 4 + c.cl.numel() * 4
                + n_valid * c.bk * d * 2 * 2 + c.q_dec.numel() * 2)
    b2_flops = n_valid * g * c.bk * d * 2 * 2
    valid_rows = c.qpos < n_k
    pairs = int(torch.where(valid_rows, c.qpos.long() + 1, 0).sum())
    # pages a query block can see, counted once per bh row
    seen = torch.where(valid_rows, c.qpos, -1).amax(dim=1)
    seen_pages = int(((seen.long() + c.bk) // c.bk).clamp(min=0).sum())
    b3_bytes = (qpp.numel() * 4 + qps.numel() * 4 + c.qpos.numel() * 4
                + c.bt.numel() * 4 + seen_pages * (c.bk * d * 2 + 4)
                + 2 * p0.numel() * 4)
    b3_ops = pairs * d * 2 * 2
    n_pvalid = int(pval.sum())
    b4_bytes = (c.q_pre.numel() * 2 * 2 + c.qpos.numel() * 4
                + 2 * pidx.numel() * 4 + n_pvalid * c.bk * d * 2 * 2)
    b4_flops = n_pvalid * c.bq * c.bk * d * 2 * 2

    def bound(nbytes, ops, peak):
        tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / peak * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    for name, fn, plain, lib, nbytes, ops_n, peak in (
        ("mpmrf_paged_filter_scores", b1, b1p, None, b1_bytes, b1_ops,
         H100_INT8_OPS),
        ("paged_decode_gather_attention", b2, b2p, sdpa_dec, b2_bytes,
         b2_flops, H100_BF16_FLOPS),
        ("mpmrf_paged_prefill_filter_scores", b3, b3p, None, b3_bytes,
         b3_ops, H100_INT8_OPS),
        ("paged_prefill_gather_attention", b4, b4p, sdpa_pre, b4_bytes,
         b4_flops, H100_BF16_FLOPS),
    ):
        r = results[name][-1]
        r["ms"] = time_ms(fn)
        r["plain_ms"] = time_ms(plain, iters=5, warmup=1)
        r["library_ms"] = time_ms(lib) if lib is not None else None
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops_n, peak)
        lib_txt = ("n/a" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
        log(f"[time:{label}] {KERNELS[name]['id']} {name}: "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
            f"{lib_txt}, bound {r['bound_ms']:.4f} by {r['bound_by']})")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def small_reference_check():
    """Serve-smoke model in bf16 on the card: logits through the kernels
    vs the same model with the plain versions swapped in."""
    import torch

    from repro_torch.configs.registry import get_serve_config
    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_prefill as pk
    from repro_torch.models import LMModel

    cfg = dataclasses.replace(get_serve_config("qwen3-14b", smoke=True),
                              dtype="bfloat16")
    model = LMModel(cfg, device=DEV)
    params = model.init(seed=1)
    bsz, chunk, max_len = 2, 8, 64
    gen = torch.Generator(device=DEV).manual_seed(3)
    toks = torch.randint(1, cfg.vocab_size - 1, (bsz, 5 * chunk),
                         generator=gen, device=DEV)
    table = torch.arange(bsz * (max_len // 16), dtype=torch.int32,
                         device=DEV).reshape(bsz, -1)

    def run():
        cache = model.init_paged_cache(bsz * max_len // 16, max_len=max_len)
        outs = []
        for c in range(5):
            pos = (c * chunk + torch.arange(chunk, device=DEV))[None].expand(bsz, -1)
            logits, cache = model.prefill(
                params, cache, {"tokens": toks[:, c * chunk:(c + 1) * chunk],
                                "positions": pos, "block_table": table},
                torch.zeros(bsz, dtype=torch.int32, device=DEV))
            outs.append(logits)
        nxt = outs[-1][:, -1].argmax(-1)
        idx = torch.full((bsz,), 5 * chunk, dtype=torch.int32, device=DEV)
        for _ in range(2):
            logits, cache = model.decode_step(
                params, cache, {"tokens": nxt[:, None], "block_table": table},
                idx)
            outs.append(logits)
            nxt = logits[:, -1].argmax(-1)
            idx = idx + 1
        return torch.cat([o.reshape(-1, o.shape[-1]) for o in outs])

    fast = run()
    swaps = [(dk, "paged_filter_scores"), (dk, "paged_decode_gather_attention"),
             (pk, "paged_prefill_filter_scores"),
             (pk, "paged_prefill_gather_attention")]
    saved = [(m, n, getattr(m, n)) for m, n in swaps]
    try:
        for m, n in swaps:
            setattr(m, n, getattr(m, n + "_plain"))
        plain = run()
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    need(bool(torch.isfinite(fast).all()), "small model: non-finite logits")
    diff = fast - plain
    err = diff.abs().max().item()
    rel = (diff.norm() / plain.norm()).item()
    log(f"[small] serve-smoke bf16 logits, kernels vs plain versions: "
        f"max |err| {err:.3e}, ‖err‖/‖ref‖ {rel:.3e} (max |logit| "
        f"{plain.abs().max().item():.3e}, rms "
        f"{plain.pow(2).mean().sqrt().item():.3e})")
    need(rel <= SMALL_REL_TOL,
         f"small model logits differ by {rel:.3e} of their norm")


def serve_full_width(cfg, *, seed=0, n_req=8, prompt_len=2048,
                     system_len=SYSTEM_LEN, new_tokens=32, max_len=4096,
                     chunk=128):
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import LMModel
    from repro_torch.runtime import Request, ServeLoop

    t0 = time.perf_counter()
    model = LMModel(cfg, device=DEV)
    params = model.init(seed=seed)
    sync()
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}H/{cfg.num_kv_heads}KV, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype} weights "
        f"{mem_gb(torch.cuda.memory_allocated)} GB, init "
        f"{time.perf_counter() - t0:.1f} s")
    engine = ServeLoop(
        model, params, batch_slots=n_req, max_len=max_len, eos_token=-1,
        seed=seed, prefill_chunk=chunk, prefix_sharing=True, device=DEV,
    )
    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab_size - 1, size=system_len).tolist()
    prompts = [system + rng.integers(1, cfg.vocab_size - 1,
                                     size=prompt_len - system_len).tolist()
               for _ in range(n_req)]

    def drive(uid0):
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=uid0 + i, prompt=list(p),
                                  max_new_tokens=new_tokens))
        t = time.perf_counter()
        done = engine.run_until_drained()
        sync()
        return [r for r in done if r.uid >= uid0], time.perf_counter() - t

    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    done, wall = drive(0)
    launches = dict(_build.launch_counts)
    m = engine.metrics
    lat = m.latency_stats()
    log(f"[serve] run 1: {len(done)} requests drained in {wall:.2f} s; "
        f"prefill {m.prefill_tokens} tok in {m.prefill_time:.3f} s "
        f"({m.prefill_tokens_per_sec:.1f} tok/s), decode {m.decode_tokens} "
        f"tok in {m.decode_time:.3f} s ({m.decode_tokens_per_sec:.1f} tok/s); "
        f"ttft p50/p95 {lat['ttft_p50'] * 1e3:.1f}/{lat['ttft_p95'] * 1e3:.1f}"
        f" ms, itl p50/p95 {lat['itl_p50'] * 1e3:.2f}/"
        f"{lat['itl_p95'] * 1e3:.2f} ms; peak {m.peak_pages_in_use} pages, "
        f"peak device memory {mem_gb(torch.cuda.max_memory_allocated)} GB")
    log(f"[serve] run 1 kernel launches: {json.dumps(launches)}")
    run1 = dict(
        prefill_tok_s=m.prefill_tokens_per_sec,
        decode_tok_s=m.decode_tokens_per_sec, wall_s=wall,
        ttft_p50_ms=lat["ttft_p50"] * 1e3, ttft_p95_ms=lat["ttft_p95"] * 1e3,
        itl_p50_ms=lat["itl_p50"] * 1e3, itl_p95_ms=lat["itl_p95"] * 1e3,
    )
    need(len(done) == n_req and all(r.done for r in done),
         "not every request drained")
    need(all(len(r.tokens_out) == new_tokens for r in done),
         f"a request stopped short of {new_tokens} tokens")
    need(m.nonfinite_logits == 0, f"{m.nonfinite_logits} non-finite logits")
    for name, n in launches.items():
        need(n > 0, f"kernel {name} never launched on the serving path")
    streams1 = {r.uid: list(r.tokens_out) for r in done}

    pf_tok, pf_time = m.prefill_tokens, m.prefill_time
    done2, wall2 = drive(100)
    streams2 = {r.uid - 100: list(r.tokens_out) for r in done2}
    log(f"[serve] run 2 (same prompts, prefix cache warm): {len(done2)} "
        f"requests in {wall2:.2f} s; prefix hit-rate "
        f"{m.prefix_hit_rate:.2f}, {m.prefill_tokens_skipped} prefill tok "
        f"skipped, {m.prefill_tokens - pf_tok} recomputed in "
        f"{m.prefill_time - pf_time:.3f} s")
    need(streams1 == streams2, "run 2 streams differ from run 1")
    need(m.prefix_hits > 0, "run 2 never hit the prefix cache")
    return engine, prompts, run1, launches


def live_pool_case(engine, prompts, layer):
    """Kernel operands on the live pool of ``layer`` after serving: each
    finished request's registered pages form its block table."""
    import torch

    model = engine.model
    cfg = model.cfg
    bk = engine.layout.page_size
    mb = engine.layout.max_blocks
    tables, lens = [], []
    for p in prompts:
        pages = engine.allocator.match_prefix(p)
        tables.append(pages + [0] * (mb - len(pages)))
        lens.append(len(pages) * bk)
    need(all(n > 0 for n in lens), "no registered pages after serving")
    table = torch.tensor(tables, dtype=torch.int32, device=DEV)
    cl = torch.tensor(lens, dtype=torch.int32, device=DEV)
    heads, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    chunk = engine.prefill_chunk
    gen = torch.Generator(device=DEV).manual_seed(7)
    pool = engine.cache
    # the last prompt chunk of each request, tiled over the G groups
    pos = (cl.long()[:, None] - chunk
           + torch.arange(chunk, device=DEV)[None, :])
    # queries: the pool's own keys at those positions, so scores are live
    kq = pool["k"][layer][:, (table.long()[:, :, None] * bk
                              + torch.arange(bk, device=DEV)).reshape(
                                  len(prompts), -1)]      # [KV, B, rows, d]
    kq = kq.movedim(1, 0)
    q_pre = torch.stack([kq[b, :, pos[b]] for b in range(len(prompts))])
    q_pre = q_pre.repeat(1, 1, g, 1) + 0.1 * torch.randn(
        q_pre.shape[:2] + (g * chunk, q_pre.shape[-1]), generator=gen,
        device=DEV, dtype=q_pre.dtype)
    q_dec = q_pre[:, :, -g:].contiguous()
    return make_case(
        q_dec, cl, q_pre, pos.repeat(1, g).to(torch.int32),
        pool["k"][layer], pool["v"][layer], pool["k_codes"][layer],
        pool["k_scale"][layer], table, bk=bk, bq=cfg.energon.query_block,
        ratio=cfg.energon.pruning_ratio,
    )


def profile_drain(engine, system, *, seed=1, n_req=8, prompt_len=2048,
                  new_tokens=16):
    """Serve fresh prompts (the same system prompt, new bodies) on
    ``engine`` under ``torch.profiler``: device time by kernel, and the
    share of the drain's wall time the device was busy."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import Request

    vocab = engine.model.cfg.vocab_size
    rng = np.random.default_rng(seed)
    m = engine.metrics
    pf0, dec0 = m.prefill_time, m.decode_time
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for i in range(n_req):
            body = rng.integers(1, vocab - 1, size=prompt_len - len(system))
            engine.submit(Request(uid=1000 + i, prompt=system + body.tolist(),
                                  max_new_tokens=new_tokens))
        t0 = time.perf_counter()
        engine.run_until_drained()
        sync()
        wall = time.perf_counter() - t0
    # device time = the kernels' and copies' own intervals (op rows of
    # key_averages() also carry the device time of what they launch)
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in per_kernel.values())
    need(busy_us > 0, "the profiler saw no device time")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    out = dict(wall_s=wall, prefill_s=m.prefill_time - pf0,
               decode_s=m.decode_time - dec0, device_busy_s=busy_us / 1e6,
               idle_share=1 - busy_us / 1e6 / wall,
               top=[dict(name=k[:90], calls=c, device_ms=us / 1e3)
                    for k, (c, us) in top])
    log(f"[profile] {n_req} fresh prompts of {prompt_len} tokens, "
        f"{new_tokens} new each: wall {wall:.3f} s (prefill "
        f"{out['prefill_s']:.3f} s, decode {out['decode_s']:.3f} s), "
        f"device busy {out['device_busy_s']:.3f} s, idle "
        f"{out['idle_share']:.1%} (under the profiler)")
    for r in out["top"]:
        log(f"[profile] {r['device_ms']:10.2f} ms  x{r['calls']:<6d} "
            f"{r['name']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=40,
                    help="qwen3-14b depth to serve (width is never cut)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)}")
    secs = _build.build()
    log(f"[build] nvcc built {', '.join(_build.SOURCES)} in {secs:.1f} s "
        f"(parallel, sm_90a)")
    for name, report in _build.build_info["ptxas"].items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas:{name}] {line.strip()}")

    results = {name: [] for name in KERNELS}
    gen = torch.Generator(device=DEV).manual_seed(0)
    check_case(random_case(gen), "random", results)
    small_reference_check()
    from repro_torch.configs.registry import get_serve_config

    cfg = get_serve_config("qwen3-14b")
    if args.layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
        log(f"[serve] depth cut to {args.layers} of {get_serve_config('qwen3-14b').num_layers} layers (width unchanged)")
    engine, prompts, run1, launches = serve_full_width(cfg)
    layer = engine.model.cfg.energon.min_prune_layer
    check_case(live_pool_case(engine, prompts, layer), f"live-layer{layer}",
               results)
    prof = profile_drain(engine, prompts[0][:SYSTEM_LEN])

    timed_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, meta in KERNELS.items():
        rand, live = results[name]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=max(rand["err"], live["err"]),
            **{k: live[k] for k in timed_keys},
            random={k: rand[k] for k in ("err",) + timed_keys},
        ))
    log(json.dumps({"serve": run1, "profile": prof, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)

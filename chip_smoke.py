#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

Run from the repository root: ``python3 chip_smoke.py`` (``--layers N``
cuts qwen3-14b's depth, never its width). Phases:

1. The card's name and power limit, torch/CUDA versions, and the
   ``nvcc`` build of every kernel from ``src/repro_torch/kernels/csrc``
   (the tile-engine sources always rebuilt): the registers and spill
   bytes ``ptxas`` reports for each instantiation of the kernels on the
   tile engine of ``flash_common.cuh`` (B2/B6 and B4/B8 per head dim and
   layout, B10, B11), and a failure on any spill at d 128.
2. Each kernel of the serving path (B1–B4) at the path's shapes on
   random inputs, held against its plain PyTorch version on the card:
   filter scores (B1, B3) and the selection made from them must be
   bit-equal; the bf16 gathers (B2, B4) must agree within
   |Δ| ≤ 1e-3 + 1.6e-2·|ref| (two bf16 ulps: both sides compute in f32
   from the same bf16 inputs and round the output once, so they differ
   by one ulp at most; ``repro_torch.kernels.gather_within_tolerance``),
   B4 also on the rows of a sequence's first chunk (positions < 32)
   alone. Then each kernel, its plain version and one PyTorch call
   computing the same function where one exists (SDPA over the gathered
   survivors, timed only) are timed with CUDA events; the gathers
   rebuilt on the tile engine (B2, B4, B6, B8) print their previous
   design's time beside.
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
   ``torch.profiler``: the share of the wall time the device was busy,
   the largest device items and each of the port's kernels' device
   time and calls (``[profile] the port's kernels``).

Then the contiguous (unpaged) cache, on the same model object and
weights, once the paged engine is released:

7. B5–B8 on random inputs at the unpaged path's shapes (bh = 64 rows of
   8 slots × 8 KV heads, n_k 4096, G = 5, chunk 128, key blocks of 64,
   an idle slot's ``max_len + 1`` length and sentinel rows): B5 / B7
   scores and the survivor tables selected from them bit-equal to the
   plain versions, B6 / B8 within the gather tolerance (B8 also on its
   first-chunk rows alone); the same rows
   laid out as shuffled pages give B1 = B5, B2 = B6, B3 = B7, B4 = B8
   bit for bit; B7 once more at key block 128 over 64-row scale groups.
   Each kernel, its plain version and (B6, B8) SDPA over the gathered
   survivors timed.
8. ``ServeLoop(paged=False)`` serving phase 4's 8 requests (launch
   counts zeroed just before, read just after): B5 / B6 launch once per
   sparse layer (2–39) per decode step, B7 / B8 once per sparse layer
   per prefill wave, B1–B4 and B9–B11 never; every request drains with
   finite logits and the greedy stream of the paged run 1. Prefill and
   decode tok/s, TTFT and ITL p50 and peak device memory are printed.
9. Phase 7's checks and times on layer 2's queries of the last prefill
   wave and decode step, over its live contiguous cache; then the same
   requests through a fresh paged engine and a fresh unpaged one, warm,
   so the two layouts' tok/s are taken in turns in one call
   (``[in-turns]``; each must give phase 4's streams).

Then full-sequence scoring (``LMModel.apply`` / ``loss``, impl
"pallas": B9 → Eq. 3 + top-B → B10 in the sparse layers) on the same
model object and weights, once the serving engines are released:

10. B9–B11 on random bf16 q/k/v at the scoring path's shapes ([160,
    2048, 128]: 4 sequences × 40 heads; query block 128, key block 64,
    budget 8; B11 in 128 × 128 tiles), and once more with the queries'
    second half at q_offset 1024: B9's scores and the survivor table
    bit-equal to the plain versions', B10 and B11 within the gather
    tolerance, overall and on their first 32 query rows on their own
    (where P rounded once to bf16 would fail), B10 with every causal
    block a survivor against B11. Each
    kernel, its plain version and its library call (SDPA over the
    gathered survivors for B10, causal SDPA for B11) timed.
11. The serve-smoke model in bf16: ``apply`` logits through B9 + B10 vs
    the plain versions swapped in, ‖Δ‖/‖ref‖ ≤ 2.5e-3.
12. ``LMModel.loss`` over 4 sequences of 2048 tokens at full width,
    launch counts zeroed just before and read just after: B9 and B10
    once per sparse layer (layers 2–39), B11 and B1–B8 never; the loss
    and every logit of a following ``apply`` finite. Wall time, tokens/s
    and peak device memory are printed; one more ``loss`` call under
    ``torch.profiler`` gives its device time by kernel and idle share.
13. Phase 10's checks and times again on the q/k/v that layer 2 handed
    the kernels in phase 12, and the sparse pair (B9 + selection + B10)
    timed against B11 on them (a measurement, not a claimed speedup).
14. ``ops.energon_block_attention`` forward and backward at a small size:
    the forward equals its composition, the gradients autograd through
    the plain block-sparse attention.

The line before last is a JSON object listing each kernel's launches
(B1–B4 in phase 4, B5–B8 in phase 8, B9–B11 in phase 12), error and
times (those of the live pool or the captured layer; ``random`` holds
phase 2's, 7's or 10's) and each time over its bound
(``ms_over_bound``); the scoring results (with the ptxas report), the
unpaged serve and the paged serve are on the lines before it; the last
line is
``{"ok": true, "device": ...}``.
Any failure exits non-zero before printing either.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

H100_BYTES_PER_S = 3.35e12        # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12          # dense tensor-core peak
H100_INT8_OPS = 1979e12           # dense tensor-core peak
SMALL_REL_TOL = 2.5e-3
#: query rows where two or three keys carry the softmax: B10/B11 (the
#: first 32 rows) and B4/B8 (the rows at positions < 32) are held to the
#: gather tolerance there on their own (P rounded once to bf16 fails it;
#: tests/test_torch_full_sequence.py)
EARLY_ROWS = 32
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
    "mpmrf_decode_filter_scores": dict(
        id="B5", source="src/repro_torch/kernels/csrc/mpmrf_decode.cu",
        replaces="src/repro/kernels/mpmrf_decode.py:90"),
    "decode_gather_attention": dict(
        id="B6", source="src/repro_torch/kernels/csrc/mpmrf_decode.cu",
        replaces="src/repro/kernels/mpmrf_decode.py:337"),
    "mpmrf_prefill_filter_scores": dict(
        id="B7", source="src/repro_torch/kernels/csrc/mpmrf_prefill.cu",
        replaces="src/repro/kernels/mpmrf_prefill.py:100"),
    "prefill_gather_attention": dict(
        id="B8", source="src/repro_torch/kernels/csrc/mpmrf_prefill.cu",
        replaces="src/repro/kernels/mpmrf_prefill.py:360"),
    "mpmrf_filter_scores": dict(
        id="B9", source="src/repro_torch/kernels/csrc/mpmrf_filter.cu",
        replaces="src/repro/kernels/mpmrf_filter.py:74"),
    "block_sparse_attention": dict(
        id="B10",
        source="src/repro_torch/kernels/csrc/block_sparse_attention.cu",
        replaces="src/repro/kernels/block_sparse_attention.py:92"),
    "flash_attention": dict(
        id="B11", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:82"),
}
#: the times (ms) of the gathers' previous design (one block per bh row
#: or query block, on CUDA cores; PERF.md §6, NVIDIA H100 80GB HBM3,
#: 700 W) on the same kinds of operands: phase 2's / 7's random case, the
#: live pool (B2, B4) or the captured layer (B6, B8). They are quoted,
#: not measured, so only the ``[time:…]`` text carries them.
EARLIER_MS = {
    "paged_decode_gather_attention": dict(random=0.2269, live=0.1247),
    "paged_prefill_gather_attention": dict(random=0.7455, live=0.3974),
    "decode_gather_attention": dict(random=0.2386, captured=0.1377),
    "prefill_gather_attention": dict(random=1.2027, captured=1.1732),
}
#: the kernels' device-side names: body → (paged, contiguous) wrapper, or
#: its one wrapper
DEVICE_NAMES = {
    "decode_filter_kernel": ("mpmrf_paged_filter_scores",
                             "mpmrf_decode_filter_scores"),
    "decode_split_kernel": ("paged_decode_gather_attention",
                            "decode_gather_attention"),
    "prefill_filter_kernel": ("mpmrf_paged_prefill_filter_scores",
                              "mpmrf_prefill_filter_scores"),
    "prefill_gather_kernel": ("paged_prefill_gather_attention",
                              "prefill_gather_attention"),
    "filter_scores_kernel": ("mpmrf_filter_scores",),
    "block_sparse_attention_kernel": ("block_sparse_attention",),
    "flash_attention_kernel": ("flash_attention",),
}
SERVE_KERNELS = tuple(KERNELS)[:4]        # B1–B4: the paged serving path
UNPAGED_KERNELS = tuple(KERNELS)[4:8]     # B5–B8: the contiguous cache
SCORE_KERNELS = tuple(KERNELS)[8:]        # B9–B11: full-sequence scoring


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
    off[0] = 0                  # a first chunk: rows where few keys count
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


def device_ms(fn, iters=20):
    """Device time of one call of ``fn`` (ms): every kernel and copy it
    launches, summed from a ``torch.profiler`` trace of ``iters`` calls
    (warm). Beside ``time_ms``, whose CUDA-event span of back-to-back
    calls is the host's enqueue time where that exceeds the device's.
    None off the card."""
    if DEV != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(3):       # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                     ) as prof:
            for _ in range(iters):
                fn()
            sync()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    raise SmokeFailure("the profiler saw no device time")


def row_blocks(idx, n_kb):
    """A survivor table's blocks as ids unique across its bh rows
    (b·n_kb + idx)."""
    import torch

    b = torch.arange(idx.shape[0], device=idx.device).reshape(
        -1, *([1] * (idx.dim() - 1)))
    return b * n_kb + idx.long()


def distinct_blocks(blocks, valid):
    """Key blocks a gather must read at least once: the distinct ids
    among the valid slots (the query blocks of one bh row share many of
    their survivors, which the card reads from memory once)."""
    import torch

    return int(torch.unique(blocks[valid > 0]).numel())


def bound(nbytes, ops, peak):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the operands' peak rate (ms)."""
    tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_kernels(label, entries, rows, *, iters=20, plain_iters=5):
    """Time each kernel of ``rows`` (name, kernel, plain version, library
    call or None, bytes, operations, peak rate), its plain version and
    its library call with CUDA events, bound it, and write the numbers
    into ``entries[name]``."""
    for name, fn, plain, lib, nbytes, ops_n, peak in rows:
        r = entries[name]
        r["ms"] = time_ms(fn, iters=iters)
        r["plain_ms"] = time_ms(plain, iters=plain_iters, warmup=1)
        r["library_ms"] = (time_ms(lib, iters=iters) if lib is not None
                           else None)
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops_n, peak)
        lib_txt = ("n/a" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
        was = EARLIER_MS.get(name, {}).get(label.split("-")[0])
        was_txt = ""
        if was is not None and DEV == "cuda":   # a redesigned gather
            r["device_ms"] = device_ms(fn)
            r["library_device_ms"] = device_ms(lib)
            was_txt = (f", before the redesign {was:.4f}; device "
                       f"{r['device_ms']:.4f}, "
                       f"library device {r['library_device_ms']:.4f}")
        log(f"[time:{label}] {KERNELS[name]['id']} {name}: "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
            f"{lib_txt}, bound {r['bound_ms']:.4f} by {r['bound_by']}"
            f"{was_txt})")


def sdpa_decode(q, k_blocks, v_blocks, idx, val, cl, bk):
    """SDPA of the G folded rows over each row's gathered survivor blocks
    ``[bh, S, bk, d]`` under the decode kernels' mask (a yardstick)."""
    import torch
    import torch.nn.functional as F

    bh, g, d = q.shape
    kg = k_blocks.reshape(bh, 1, -1, d)
    vg = v_blocks.reshape(bh, 1, -1, d)
    kpos = (idx.long()[:, :, None] * bk
            + torch.arange(bk, device=q.device)).reshape(bh, -1)
    ok = ((val[:, :, None] > 0).expand(-1, -1, bk).reshape(bh, -1)
          & (kpos < cl.long()[:, None]))
    mask = ok[:, None, None, :].expand(bh, 1, g, ok.shape[-1])
    qd = q.reshape(bh, 1, g, d)
    return lambda: F.scaled_dot_product_attention(qd, kg, vg, attn_mask=mask)


def sdpa_prefill(q, qpos, k_blocks, v_blocks, idx, val, bq, bk, n_k):
    """SDPA of each query block over its gathered survivor blocks
    ``[bh, n_qb, S, bk, d]`` under the prefill kernels' per-row mask."""
    import torch
    import torch.nn.functional as F

    bh, n_q, d = q.shape
    n_qb = n_q // bq
    kg = k_blocks.reshape(bh * n_qb, 1, -1, d)
    vg = v_blocks.reshape(bh * n_qb, 1, -1, d)
    kpos = (idx.long()[..., None] * bk
            + torch.arange(bk, device=q.device)).reshape(bh, n_qb, 1, -1)
    slot_ok = (val[..., None] > 0).expand(-1, -1, -1, bk).reshape(
        bh, n_qb, 1, -1)
    qposr = qpos.long().reshape(bh, n_qb, bq, 1)
    mask = (slot_ok & (kpos <= qposr) & (qposr < n_k)).reshape(
        bh * n_qb, 1, bq, -1)
    qr = q.reshape(bh * n_qb, 1, bq, d)
    return lambda: F.scaled_dot_product_attention(qr, kg, vg, attn_mask=mask)


def early_rows_err(out, ref, qpos, label, kid):
    """Hold a prefill gather's rows at positions < EARLY_ROWS (a
    sequence's first chunk, where two or three keys carry a row) to the
    gather tolerance on their own; their max |err|, or None when the case
    has no such row."""
    from repro_torch.kernels import gather_within_tolerance

    early = qpos < EARLY_ROWS
    if not bool(early.any()):
        return None
    o, r = out[early], ref[early]
    err = (o - r).abs().max().item()
    need(gather_within_tolerance(o, r),
         f"{label} {kid} off by {err:.3e} on its rows at positions < "
         f"{EARLY_ROWS}")
    return err


def fmt_err(err):
    return "n/a" if err is None else f"{err:.3e}"


def quantized_q(q):
    from repro_torch.core import quantization as qlib

    q16 = qlib.quantize_int16(q, axis=-1)
    return q16.bit_plane(4).contiguous(), q16.scale.contiguous()


def check_case(case, label, results):
    """Hold B1–B4 against their plain versions on ``case``; time them."""
    import torch

    from repro_torch.core.energon_attention import (
        _prefill_diag_blocks, decode_live_budget,
    )
    from repro_torch.kernels import gather_within_tolerance
    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_prefill as pk
    from repro_torch.kernels import ops

    c = case
    _, g, d = c.q_dec.shape
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
        dict(err=err, ref_rms=ref.pow(2).mean().sqrt().item(),
             err_first_rows=early_rows_err(out, ref, c.qpos, label, "B4")))
    r2 = results["paged_decode_gather_attention"][-1]
    r4 = results["paged_prefill_gather_attention"][-1]
    log(f"[kernels:{label}] B1/B3 bit-equal (scores and selection); "
        f"B2 max |err| {r2['err']:.3e} (rms |ref| {r2['ref_rms']:.3e}), "
        f"B4 max |err| {r4['err']:.3e} (rms |ref| {r4['ref_rms']:.3e}; "
        f"rows at positions < {EARLY_ROWS} "
        f"{fmt_err(r4['err_first_rows'])})")

    # --- yardsticks: SDPA over the gathered survivors (timed only) -------
    pages = torch.gather(c.bt.long(), 1, idx.long())
    sdpa_dec = sdpa_decode(c.q_dec, c.k_pages[pages], c.v_pages[pages], idx,
                           val, c.cl, c.bk)
    ppages = torch.gather(c.bt.long()[:, None, :].expand(-1, n_qb, -1), 2,
                          pidx.long())
    sdpa_pre = sdpa_prefill(c.q_pre, c.qpos, c.k_pages[ppages],
                            c.v_pages[ppages], pidx, pval, c.bq, c.bk, n_k)

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
                + 2 * pidx.numel() * 4
                + distinct_blocks(ppages, pval) * c.bk * d * 2 * 2)
    b4_flops = n_pvalid * c.bq * c.bk * d * 2 * 2

    time_kernels(label, {name: results[name][-1] for name in SERVE_KERNELS}, (
        ("mpmrf_paged_filter_scores", b1, b1p, None, b1_bytes, b1_ops,
         H100_INT8_OPS),
        ("paged_decode_gather_attention", b2, b2p, sdpa_dec, b2_bytes,
         b2_flops, H100_BF16_FLOPS),
        ("mpmrf_paged_prefill_filter_scores", b3, b3p, None, b3_bytes,
         b3_ops, H100_INT8_OPS),
        ("paged_prefill_gather_attention", b4, b4p, sdpa_pre, b4_bytes,
         b4_flops, H100_BF16_FLOPS),
    ))


# ---------------------------------------------------------------------------
# the full-sequence kernels (B9–B11) on one layer's [B·H, n, d] operands
# ---------------------------------------------------------------------------


def causal_pairs(n_q, n_k, q_offset):
    """(query, key) pairs the causal mask admits: row i sees keys
    0 .. q_offset + i (at most n_k)."""
    import torch

    rows = torch.arange(n_q) + q_offset
    return int(torch.clamp(rows + 1, 0, n_k).sum())


def survivor_pairs(idx, val, bq, bk, q_offset):
    """Causally admitted (query, key) pairs inside the valid survivor
    tiles of a ``[bh, n_qb, B]`` table."""
    import torch

    n_qb = idx.shape[1]
    qpos = (q_offset + torch.arange(n_qb, device=idx.device)[:, None] * bq
            + torch.arange(bq, device=idx.device))             # [n_qb, bq]
    seen = torch.clamp(qpos[None, :, None, :] - idx.long()[..., None] * bk
                       + 1, 0, bk)                            # [bh,n_qb,B,bq]
    return int((seen.sum(-1) * val).sum())


def check_full_sequence(q, k, v, label, results, *, bq, bk, ratio,
                        q_offset=0, timed=True):
    """Hold B9–B11 against their plain versions on q ``[bh, n_q, d]``,
    k/v ``[bh, n_k, d]`` (bf16): B9's scores and the survivor table made
    from them bit-equal; B10 and B11 within the gather tolerance; B10
    with every causal block a survivor (ρ ≤ 1) against B11. With
    ``timed``, each kernel, its plain version and its library call are
    timed and bounded from this case's data."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import block_sparse_attention as bsa
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_within_tolerance
    from repro_torch.kernels import mpmrf_filter as fk
    from repro_torch.kernels import ops

    bh, n_q, d = q.shape
    n_k = k.shape[1]
    n_qb, n_kb = n_q // bq, n_k // bk
    budget = max(1, math.ceil(n_kb / ratio))
    fa_block = 128                        # B11's tile (the reference's default)

    # --- B9 + selection ---------------------------------------------------
    qp, kmsb, krem, qs, ks = ops.full_sequence_planes(q, k)
    fkw = dict(shift=2, query_block=bq, key_block=bk, causal=True,
               q_offset=q_offset)
    b9 = lambda: fk.mpmrf_filter_scores(qp, kmsb, krem, qs, **fkw)
    b9p = lambda: fk.mpmrf_filter_scores_plain(qp, kmsb, krem, qs, **fkw)
    s0, s1 = b9()
    r0, r1 = b9p()
    sync()
    need(torch.equal(s0, r0) and torch.equal(s1, r1),
         f"{label} B9 scores differ from the plain version")
    skw = dict(block_budget=budget, query_block=bq, key_block=bk)
    idx, val = ops.select_from_scores(s0, s1, ks, **skw)
    ridx, rval = ops.select_from_scores(r0, r1, ks, **skw)
    need(torch.equal(idx, ridx) and torch.equal(val, rval),
         f"{label} B9 selection differs")
    entry = {"mpmrf_filter_scores": dict(label=label, err=0.0)}

    # --- B10, B11, and B10 over every causal block --------------------------
    akw = dict(query_block=bq, key_block=bk, causal=True, q_offset=q_offset)
    b10 = lambda: bsa.block_sparse_attention(q, k, v, idx, val, **akw)
    b10p = lambda: bsa.block_sparse_attention_plain(q, k, v, idx, val, **akw)
    b11 = lambda: fa.flash_attention(q, k, v, causal=True, q_offset=q_offset,
                                     block_q=fa_block, block_k=fa_block)
    b11p = lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                            q_offset=q_offset)
    dense = b11().float()
    first = EARLY_ROWS
    for name, fn, plain in (("block_sparse_attention", b10, b10p),
                            ("flash_attention", None, b11p)):
        out = dense if fn is None else fn().float()
        ref = plain().float()
        err = (out - ref).abs().max().item()
        err_first = (out[:, :first] - ref[:, :first]).abs().max().item()
        need(gather_within_tolerance(out, ref),
             f"{label} {KERNELS[name]['id']} off by {err:.3e}")
        need(gather_within_tolerance(out[:, :first], ref[:, :first]),
             f"{label} {KERNELS[name]['id']} off by {err_first:.3e} on "
             f"its first {first} query rows")
        entry[name] = dict(label=label, err=err, err_first_rows=err_first,
                           ref_rms=ref.pow(2).mean().sqrt().item())
    all_idx = torch.arange(n_kb, device=DEV, dtype=torch.int32).expand(
        bh, n_qb, n_kb).contiguous()
    every = bsa.block_sparse_attention(q, k, v, all_idx,
                                       torch.ones_like(all_idx), **akw)
    keep_all_err = (every.float() - dense).abs().max().item()
    need(gather_within_tolerance(every.float(), dense),
         f"{label} B10 over every causal block differs from B11 by "
         f"{keep_all_err:.3e}")
    kept = int(val.sum())
    causal_tiles = bh * sum(
        1 for i in range(n_qb) for j in range(n_kb)
        if j * bk <= q_offset + i * bq + bq - 1)
    log(f"[full-seq:{label}] bh {bh}, n_q {n_q}, n_k {n_k}, d {d}, "
        f"q_offset {q_offset}: B9 bit-equal (scores and selection; "
        f"{kept} survivor tiles of {causal_tiles} causal, budget "
        f"{budget}); B10 max |err| "
        f"{entry['block_sparse_attention']['err']:.3e} (first {first} rows "
        f"{entry['block_sparse_attention']['err_first_rows']:.3e}; rms "
        f"|ref| {entry['block_sparse_attention']['ref_rms']:.3e}), B11 max "
        f"|err| {entry['flash_attention']['err']:.3e} (first {first} rows "
        f"{entry['flash_attention']['err_first_rows']:.3e}); B10 over every "
        f"causal block vs B11 max |err| {keep_all_err:.3e}")
    for name, e in entry.items():
        results[name].append(e)
    if not timed:
        return None

    # --- yardsticks (timed only) ---------------------------------------------
    rows = torch.arange(bh, device=DEV)[:, None, None]
    kg = k.view(bh, n_kb, bk, d)[rows, idx.long()].reshape(bh * n_qb, 1, -1, d)
    vg = v.view(bh, n_kb, bk, d)[rows, idx.long()].reshape(bh * n_qb, 1, -1, d)
    qpos = (q_offset + torch.arange(n_qb, device=DEV)[:, None] * bq
            + torch.arange(bq, device=DEV))                  # [n_qb, bq]
    kpos = (idx.long()[..., None] * bk
            + torch.arange(bk, device=DEV)).reshape(bh, n_qb, 1, -1)
    slot_ok = (val[..., None] > 0).expand(-1, -1, -1, bk).reshape(
        bh, n_qb, 1, -1)
    mask = (slot_ok & (kpos <= qpos[None, :, :, None])).reshape(
        bh * n_qb, 1, bq, -1)
    qr = q.reshape(bh * n_qb, 1, bq, d)
    sdpa_sparse = lambda: F.scaled_dot_product_attention(qr, kg, vg,
                                                         attn_mask=mask)
    sdpa_dense = None
    if q_offset == 0 and n_q == n_k:
        sdpa_dense = lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True)

    # --- bounds from this case's data ----------------------------------------
    pairs = causal_pairs(n_q, n_k, q_offset) * bh
    b9_bytes = 3 * q.numel() + qs.numel() * 4 + 2 * s0.numel() * 4
    b9_ops = pairs * d * 2 * 2            # two rounds of multiply-add
    b10_bytes = (q.numel() * 2 * 2 + 2 * idx.numel() * 4
                 + distinct_blocks(row_blocks(idx, n_kb), val) * bk * d * 2 * 2)
    b10_flops = survivor_pairs(idx, val, bq, bk, q_offset) * d * 2 * 2
    b11_bytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2
    b11_flops = pairs * d * 2 * 2

    time_kernels(label, entry, (
        ("mpmrf_filter_scores", b9, b9p, None, b9_bytes, b9_ops,
         H100_INT8_OPS),
        ("block_sparse_attention", b10, b10p, sdpa_sparse, b10_bytes,
         b10_flops, H100_BF16_FLOPS),
        ("flash_attention", b11, b11p, sdpa_dense, b11_bytes, b11_flops,
         H100_BF16_FLOPS),
    ), iters=10, plain_iters=3)
    timing = {name: r["ms"] for name, r in entry.items()}
    return dict(survivor_tiles=kept, causal_tiles=causal_tiles,
                budget=budget, ms=timing)


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
    for name in SERVE_KERNELS:
        need(launches[name] > 0,
             f"kernel {name} never launched on the serving path")
    for name in UNPAGED_KERNELS + SCORE_KERNELS:
        need(launches[name] == 0, f"{name} launched on the paged path")
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
    return engine, prompts, run1, launches, streams1


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
    split = device_split(prof, wall)
    out = dict(wall_s=wall, prefill_s=m.prefill_time - pf0,
               decode_s=m.decode_time - dec0, **split)
    log(f"[profile] {n_req} fresh prompts of {prompt_len} tokens, "
        f"{new_tokens} new each: wall {wall:.3f} s (prefill "
        f"{out['prefill_s']:.3f} s, decode {out['decode_s']:.3f} s), "
        f"device busy {out['device_busy_s']:.3f} s, idle "
        f"{out['idle_share']:.1%} (under the profiler)")
    for r in out["top"]:
        log(f"[profile] {r['device_ms']:10.2f} ms  x{r['calls']:<6d} "
            f"{r['name']}")
    log("[profile] the port's kernels: " + ", ".join(
        f"{k} {r['device_ms']:.2f} ms over {r['calls']} calls"
        for k, r in out["port"].items()))
    return out


def device_split(prof, wall, top=12):
    """Device time by kernel from a ``torch.profiler`` run: the kernels'
    and copies' own intervals (op rows of key_averages() also carry the
    device time of what they launch), their sum, and the share of
    ``wall`` seconds the device sat idle."""
    from torch.autograd import DeviceType

    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in per_kernel.values())
    need(busy_us > 0, "the profiler saw no device time")
    items = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:top]
    port = {}
    for name, (calls, us) in per_kernel.items():
        m = re.match(r"void (\w+)<\d+(, (true|false))?>", name)
        if m and m.group(1) in DEVICE_NAMES:
            wrappers = DEVICE_NAMES[m.group(1)]
            wrapper = wrappers[0 if m.group(3) != "false" else 1]
            kid = KERNELS[wrapper]["id"]
            c0, us0 = port.get(kid, (0, 0.0))
            port[kid] = (c0 + calls, us0 + us)
    return dict(device_busy_s=busy_us / 1e6,
                idle_share=1 - busy_us / 1e6 / wall,
                top=[dict(name=k[:90], calls=c, device_ms=us / 1e3)
                     for k, (c, us) in items],
                port={k: dict(calls=c, device_ms=us / 1e3)
                      for k, (c, us) in sorted(port.items())})


# ---------------------------------------------------------------------------
# the contiguous-cache serving path (B5–B8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ContiguousCase:
    """Operands of B5–B8 for one decode step and one prefill chunk of a
    sparse layer over the contiguous cache: ``bh = B·KV`` rows of
    ``n_k`` keys, planes scaled per ``bk``-row block."""

    q_dec: object       # [bh, G, d] bf16
    cl: object          # [bh] int32
    q_pre: object       # [bh, n_q, d] bf16
    qpos: object        # [bh, n_q] int32
    k: object           # [bh, n_k, d] bf16
    v: object
    codes: object       # [bh, n_k, d] int16
    scale: object       # [bh, n_k // bk] f32
    bk: int             # decode key block = the planes' scale block
    pk: int             # prefill key block (B7 / B8)
    bq: int
    ratio: float


def random_contiguous_case(gen, *, bh=64, g=5, d=128, n_k=4096, bk=64,
                           pk=64, chunk=128, bq=128, ratio=4.0):
    """Random operands at the unpaged path's shapes, with an idle slot's
    ``max_len + 1`` length and a ragged tail of sentinel rows."""
    import torch

    from repro_torch.core import quantization as qlib

    dev = DEV
    k = torch.randn((bh, n_k, d), generator=gen, device=dev).to(
        torch.bfloat16)
    codes, scales = qlib.quantize_int16_blocks(k, bk)
    cl = torch.randint(1, n_k + 1, (bh,), generator=gen, device=dev)
    cl[0] = n_k + 1
    off = torch.randint(0, n_k // chunk, (bh,), generator=gen,
                        device=dev) * chunk
    off[2] = 0                  # a first chunk: rows where few keys count
    pos = off[:, None] + torch.arange(chunk, device=dev)[None, :]
    pos[1, -9:] = n_k
    return ContiguousCase(
        q_dec=torch.randn((bh, g, d), generator=gen, device=dev).to(
            torch.bfloat16),
        cl=cl.to(torch.int32),
        q_pre=torch.randn((bh, g * chunk, d), generator=gen, device=dev).to(
            torch.bfloat16),
        qpos=pos.repeat(1, g).to(torch.int32), k=k,
        v=torch.randn((bh, n_k, d), generator=gen, device=dev).to(
            torch.bfloat16),
        codes=codes, scale=scales, bk=bk, pk=pk, bq=bq, ratio=ratio,
    )


def contiguous_selection(c, s0, s1, p0, p1):
    """The survivor tables the path selects from B5's and B7's scores."""
    from repro_torch.core.energon_attention import (
        _prefill_diag_blocks, decode_live_budget,
    )
    from repro_torch.kernels import ops

    n_k = c.k.shape[1]
    lb = decode_live_budget(c.cl, c.bk, c.ratio)
    idx, val, _ = ops._fused_decode_select(
        s0, s1, c.cl, alphas=(0.0, 0.0), key_block=c.bk,
        block_budget=max(1, math.ceil(n_k // c.bk / c.ratio)),
        keep_all=False, keep_first=True, keep_diagonal=True,
        live_budget=lb, heads=1)
    pidx, pval, _ = ops._fused_prefill_select(
        p0, p1, round_bits=(2, 4), alphas=(0.0, 0.0), query_block=c.bq,
        key_block=c.pk, block_budget=max(1, math.ceil(n_k // c.pk / c.ratio)),
        keep_all=False, keep_first=True, keep_diagonal=True,
        diag_blocks=_prefill_diag_blocks(c.qpos, c.bq, c.pk, n_k), heads=1)
    return idx, val, pidx, pval


def check_contiguous(c, label, results, *, timed=True, gather=True):
    """Hold B5–B8 against their plain versions on ``c``: B5 / B7 scores
    and the survivor tables selected from them bit-equal, B6 / B8 within
    the gather tolerance. With ``timed``, each kernel, its plain version
    and (B6, B8) SDPA over the gathered survivors are timed and bounded
    from this case's data. Returns the operands for
    :func:`check_same_rows`."""
    import torch

    from repro_torch.kernels import gather_within_tolerance
    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_prefill as pk

    bh, g, d = c.q_dec.shape
    n_k = c.k.shape[1]
    n_q = c.q_pre.shape[1]
    qp, qs = quantized_q(c.q_dec)
    qpp, qps = quantized_q(c.q_pre)
    row_scale = c.scale.repeat_interleave(c.bk, dim=-1).contiguous()
    fkw = dict(key_block=c.bk)
    pkw = dict(query_block=c.bq, key_block=c.pk)
    b5 = lambda: dk.mpmrf_decode_filter_scores(qp, qs, c.codes, c.scale,
                                               c.cl, **fkw)
    b5p = lambda: dk.mpmrf_decode_filter_scores_plain(qp, qs, c.codes,
                                                      c.scale, c.cl, **fkw)
    b7 = lambda: pk.mpmrf_prefill_filter_scores(qpp, qps, c.qpos, c.codes,
                                                row_scale, **pkw)
    b7p = lambda: pk.mpmrf_prefill_filter_scores_plain(
        qpp, qps, c.qpos, c.codes, row_scale, **pkw)
    s0, s1 = b5()
    r0, r1 = b5p()
    p0, p1 = b7()
    q0, q1 = b7p()
    sync()
    need(torch.equal(s0, r0) and torch.equal(s1, r1),
         f"{label} B5 scores differ from the plain version")
    need(torch.equal(p0, q0) and torch.equal(p1, q1),
         f"{label} B7 scores differ from the plain version")
    idx, val, pidx, pval = contiguous_selection(c, s0, s1, p0, p1)
    ref_sel = contiguous_selection(c, r0, r1, q0, q1)
    need(all(torch.equal(a, b) for a, b in zip(
        (idx, val, pidx, pval), ref_sel)),
        f"{label} B5/B7 survivor tables differ")
    results["mpmrf_decode_filter_scores"].append(dict(err=0.0))
    results["mpmrf_prefill_filter_scores"].append(dict(err=0.0))
    line = (f"[contiguous:{label}] bh {bh}, n_k {n_k}, d {d}, key blocks "
            f"{c.bk}/{c.pk}: B5/B7 bit-equal (scores and survivor tables)")
    if not gather:
        log(line)
        return None

    b6 = lambda: dk.decode_gather_attention(c.q_dec, c.k, c.v, idx, val,
                                            c.cl, **fkw)
    b6p = lambda: dk.decode_gather_attention_plain(c.q_dec, c.k, c.v, idx,
                                                   val, c.cl, **fkw)
    b8 = lambda: pk.prefill_gather_attention(c.q_pre, c.qpos, c.k, c.v,
                                             pidx, pval, **pkw)
    b8p = lambda: pk.prefill_gather_attention_plain(
        c.q_pre, c.qpos, c.k, c.v, pidx, pval, **pkw)
    for name, fn, plain in (("decode_gather_attention", b6, b6p),
                            ("prefill_gather_attention", b8, b8p)):
        out, ref = fn().float(), plain().float()
        err = (out - ref).abs().max().item()
        need(gather_within_tolerance(out, ref),
             f"{label} {KERNELS[name]['id']} off by {err:.3e}")
        results[name].append(dict(err=err,
                                  ref_rms=ref.pow(2).mean().sqrt().item()))
    r6 = results["decode_gather_attention"][-1]
    r8 = results["prefill_gather_attention"][-1]
    # out, ref: B8's (the loop's last)
    r8["err_first_rows"] = early_rows_err(out, ref, c.qpos, label, "B8")
    log(f"{line}; B6 max |err| {r6['err']:.3e} (rms |ref| "
        f"{r6['ref_rms']:.3e}), B8 max |err| {r8['err']:.3e} (rms |ref| "
        f"{r8['ref_rms']:.3e}; rows at positions < {EARLY_ROWS} "
        f"{fmt_err(r8['err_first_rows'])})")
    ops_in = dict(qp=qp, qs=qs, qpp=qpp, qps=qps, s=(s0, s1), p=(p0, p1),
                  idx=idx, val=val, pidx=pidx, pval=pval)
    if not timed:
        return ops_in

    # --- yardsticks: SDPA over the gathered survivors (timed only) -------
    rows = torch.arange(bh, device=DEV)[:, None]
    sdpa_dec = sdpa_decode(
        c.q_dec, c.k.view(bh, -1, c.bk, d)[rows, idx.long()],
        c.v.view(bh, -1, c.bk, d)[rows, idx.long()], idx, val, c.cl, c.bk)
    rows = rows[..., None]
    sdpa_pre = sdpa_prefill(
        c.q_pre, c.qpos, c.k.view(bh, -1, c.pk, d)[rows, pidx.long()],
        c.v.view(bh, -1, c.pk, d)[rows, pidx.long()], pidx, pval, c.bq,
        c.pk, n_k)

    # --- bounds from this case's data ------------------------------------
    n_kb = n_k // c.bk
    live_blocks = int(((c.cl.long() + c.bk - 1) // c.bk).clamp(
        max=n_kb).sum())
    b5_bytes = (qp.numel() * 4 + qs.numel() * 4 + c.cl.numel() * 4
                + live_blocks * (c.bk * d * 2 + 4) + 2 * s0.numel() * 4)
    b5_ops = live_blocks * g * c.bk * d * 2 * 2
    n_valid = int(val.sum())
    b6_bytes = (c.q_dec.numel() * 2 * 2 + 2 * idx.numel() * 4
                + c.cl.numel() * 4 + n_valid * c.bk * d * 2 * 2)
    b6_flops = n_valid * g * c.bk * d * 2 * 2
    valid_rows = c.qpos < n_k
    pairs = int(torch.where(valid_rows, c.qpos.long() + 1, 0).sum())
    seen = torch.where(valid_rows, c.qpos, -1).amax(dim=1)
    seen_blocks = int(((seen.long() + c.pk) // c.pk).clamp(min=0).sum())
    b7_bytes = (qpp.numel() * 4 + qps.numel() * 4 + c.qpos.numel() * 4
                + seen_blocks * c.pk * (d * 2 + 4) + 2 * p0.numel() * 4)
    b7_ops = pairs * d * 2 * 2
    n_pvalid = int(pval.sum())
    b8_bytes = (c.q_pre.numel() * 2 * 2 + c.qpos.numel() * 4
                + 2 * pidx.numel() * 4
                + distinct_blocks(row_blocks(pidx, n_k // c.pk), pval)
                * c.pk * d * 2 * 2)
    b8_flops = n_pvalid * c.bq * c.pk * d * 2 * 2

    time_kernels(label, {n: results[n][-1] for n in UNPAGED_KERNELS}, (
        ("mpmrf_decode_filter_scores", b5, b5p, None, b5_bytes, b5_ops,
         H100_INT8_OPS),
        ("decode_gather_attention", b6, b6p, sdpa_dec, b6_bytes, b6_flops,
         H100_BF16_FLOPS),
        ("mpmrf_prefill_filter_scores", b7, b7p, None, b7_bytes, b7_ops,
         H100_INT8_OPS),
        ("prefill_gather_attention", b8, b8p, sdpa_pre, b8_bytes, b8_flops,
         H100_BF16_FLOPS),
    ))
    return ops_in


def check_same_rows(c, o, label, gen):
    """Lay ``c``'s contiguous rows out as pages under a shuffled block
    table: B1 must equal B5, B2 equal B6, B3 equal B7 and B4 equal B8,
    bit for bit (the twins share their kernel bodies). Each pair is then
    timed in turns on those rows; returns the times."""
    import torch

    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_prefill as pk

    need(c.pk == c.bk, "the paged kernels take one page per key tile")
    bh, n_k, d = c.k.shape
    n_kb = n_k // c.bk
    table = torch.randperm(bh * n_kb, generator=gen, device=DEV)
    inv = torch.empty_like(table)
    inv[table] = torch.arange(bh * n_kb, device=DEV)
    table = table.reshape(bh, n_kb).to(torch.int32)

    def pages(x):
        return x.reshape(bh * n_kb, c.bk, d)[inv].contiguous()

    codes, k, v = pages(c.codes), pages(c.k), pages(c.v)
    scale = c.scale.reshape(-1)[inv].reshape(-1, 1).contiguous()
    row_scale = c.scale.repeat_interleave(c.bk, dim=-1).contiguous()
    pairs = {
        "B5/B1": (
            lambda: dk.mpmrf_decode_filter_scores(
                o["qp"], o["qs"], c.codes, c.scale, c.cl, key_block=c.bk),
            lambda: dk.paged_filter_scores(
                o["qp"], o["qs"], codes, scale, table, c.cl,
                key_block=c.bk)),
        "B6/B2": (
            lambda: dk.decode_gather_attention(
                c.q_dec, c.k, c.v, o["idx"], o["val"], c.cl, key_block=c.bk),
            lambda: dk.paged_decode_gather_attention(
                c.q_dec, k, v, o["idx"], o["val"], table, c.cl,
                key_block=c.bk)),
        "B7/B3": (
            lambda: pk.mpmrf_prefill_filter_scores(
                o["qpp"], o["qps"], c.qpos, c.codes, row_scale,
                query_block=c.bq, key_block=c.bk),
            lambda: pk.paged_prefill_filter_scores(
                o["qpp"], o["qps"], c.qpos, codes, scale, table,
                query_block=c.bq, key_block=c.bk)),
        "B8/B4": (
            lambda: pk.prefill_gather_attention(
                c.q_pre, c.qpos, c.k, c.v, o["pidx"], o["pval"],
                query_block=c.bq, key_block=c.bk),
            lambda: pk.paged_prefill_gather_attention(
                c.q_pre, c.qpos, k, v, o["pidx"], o["pval"], table,
                query_block=c.bq, key_block=c.bk)),
    }
    for name, (contiguous, paged) in pairs.items():
        a, b = contiguous(), paged()
        sync()
        same = (all(torch.equal(x, y) for x, y in zip(a, b))
                if isinstance(a, tuple) else torch.equal(a, b))
        need(same, f"{label} {name}: the twins differ on the same rows")
    # both twins timed in turns (paged, contiguous, contiguous, paged)
    times = {}
    for name, (contiguous, paged) in pairs.items():
        tp0, tc0 = time_ms(paged), time_ms(contiguous)
        tc1, tp1 = time_ms(contiguous), time_ms(paged)
        times[name] = dict(contiguous_ms=(tc0 + tc1) / 2,
                           paged_ms=(tp0 + tp1) / 2)
    log(f"[same-rows:{label}] the contiguous rows as {bh * n_kb} shuffled "
        f"pages: B5 = B1, B6 = B2, B7 = B3, B8 = B4 bit for bit; ms "
        f"contiguous/paged " + ", ".join(
            f"{n} {t['contiguous_ms']:.4f}/{t['paged_ms']:.4f}"
            for n, t in times.items()))
    return times


def serve_unpaged(model, params, prompts, paged_streams, *, seed=0,
                  new_tokens=32, max_len=4096, chunk=128):
    """The same requests through ``ServeLoop(paged=False)`` on the same
    model: launch counts zeroed just before and read just after; every
    request drains with finite logits and the paged run's greedy stream.
    Layer 2's queries of the last prefill wave and the last decode step
    are kept for the captured kernel case."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.runtime import Request, ServeLoop

    cfg = model.cfg
    sparse = cfg.num_layers - cfg.energon.min_prune_layer
    engine = ServeLoop(
        model, params, batch_slots=len(prompts), max_len=max_len,
        eos_token=-1, seed=seed, prefill_chunk=chunk, paged=False,
        device=DEV,
    )
    captured, calls = {}, {"prefill": 0, "decode": 0}
    real = {"prefill": ops.fused_prefill_attention,
            "decode": ops.fused_decode_attention}

    def capturing(kind):
        def fn(q, *args, **kw):
            if calls[kind] % sparse == 0:       # the first sparse layer
                pos = args[4]                   # q_positions / cache_length
                captured[kind] = (q.clone(), pos.clone())
            calls[kind] += 1
            return real[kind](q, *args, **kw)
        return fn

    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.fused_prefill_attention = capturing("prefill")
    ops.fused_decode_attention = capturing("decode")
    try:
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=list(p),
                                  max_new_tokens=new_tokens))
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        done = engine.run_until_drained()
        sync()
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    finally:
        ops.fused_prefill_attention = real["prefill"]
        ops.fused_decode_attention = real["decode"]
    m = engine.metrics
    lat = m.latency_stats()
    peak = mem_gb(torch.cuda.max_memory_allocated)
    log(f"[unpaged] {len(done)} requests drained in {wall:.2f} s; prefill "
        f"{m.prefill_tokens} tok in {m.prefill_time:.3f} s "
        f"({m.prefill_tokens_per_sec:.1f} tok/s), decode {m.decode_tokens} "
        f"tok in {m.decode_time:.3f} s ({m.decode_tokens_per_sec:.1f} "
        f"tok/s); ttft p50 {lat['ttft_p50'] * 1e3:.1f} ms, itl p50 "
        f"{lat['itl_p50'] * 1e3:.2f} ms; contiguous cache "
        f"{engine.batch_slots} × {engine.max_len} rows; peak device memory "
        f"{peak} GB")
    log(f"[unpaged] kernel launches: {json.dumps(launches)}")
    need(len(done) == len(prompts) and all(r.done for r in done),
         "unpaged: not every request drained")
    need(m.nonfinite_logits == 0,
         f"unpaged: {m.nonfinite_logits} non-finite logits")
    streams = {r.uid: list(r.tokens_out) for r in done}
    need(streams == paged_streams,
         "unpaged greedy streams differ from the paged run's")
    per = {"mpmrf_decode_filter_scores": m.decode_dispatches,
           "decode_gather_attention": m.decode_dispatches,
           "mpmrf_prefill_filter_scores": m.prefill_dispatches,
           "prefill_gather_attention": m.prefill_dispatches}
    for name, n_calls in per.items():
        need(n_calls > 0 and launches[name] == sparse * n_calls,
             f"{name} launched {launches[name]} times, not {sparse} × "
             f"{n_calls} (layers {cfg.energon.min_prune_layer}–"
             f"{cfg.num_layers - 1} of every dispatch)")
    for name in SERVE_KERNELS + SCORE_KERNELS:
        need(launches[name] == 0, f"{name} launched on the unpaged path")
    log(f"[unpaged] streams equal the paged run's, token for token; B5/B6 "
        f"{sparse} × {m.decode_dispatches} decode steps, B7/B8 {sparse} × "
        f"{m.prefill_dispatches} prefill waves; B1–B4, B9–B11 never")
    out = dict(
        prefill_tok_s=m.prefill_tokens_per_sec,
        decode_tok_s=m.decode_tokens_per_sec, wall_s=wall,
        ttft_p50_ms=lat["ttft_p50"] * 1e3, itl_p50_ms=lat["itl_p50"] * 1e3,
        peak_memory_gb=peak, prefill_dispatches=m.prefill_dispatches,
        decode_dispatches=m.decode_dispatches,
    )
    return engine, out, launches, captured


def serve_in_turns(model, params, prompts, streams, *, seed=0,
                   new_tokens=32, max_len=4096, chunk=128):
    """The same requests through a fresh paged engine (prefix sharing
    off) and then a fresh unpaged one, both warm: with phase 8's unpaged
    drain before them, the two layouts are timed in turns in one call
    (unpaged, paged, unpaged). Each must give ``streams``."""
    import torch

    from repro_torch.runtime import Request, ServeLoop

    out = {}
    for layout in ("paged", "unpaged"):
        engine = ServeLoop(
            model, params, batch_slots=len(prompts), max_len=max_len,
            eos_token=-1, seed=seed, prefill_chunk=chunk,
            paged=layout == "paged", prefix_sharing=False, device=DEV,
        )
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=list(p),
                                  max_new_tokens=new_tokens))
        t0 = time.perf_counter()
        done = engine.run_until_drained()
        sync()
        wall = time.perf_counter() - t0
        need({r.uid: list(r.tokens_out) for r in done} == streams,
             f"in turns: the {layout} streams differ from the paged run's")
        m = engine.metrics
        lat = m.latency_stats()
        out[layout] = dict(
            prefill_tok_s=m.prefill_tokens_per_sec,
            decode_tok_s=m.decode_tokens_per_sec, wall_s=wall,
            ttft_p50_ms=lat["ttft_p50"] * 1e3,
            itl_p50_ms=lat["itl_p50"] * 1e3)
        del engine, done
        gc.collect()
        torch.cuda.empty_cache()
    log("[in-turns] warm drains of the same requests, streams equal: "
        + "; ".join(f"{k} prefill {v['prefill_tok_s']:.1f} tok/s, decode "
                    f"{v['decode_tok_s']:.1f} tok/s, ttft p50 "
                    f"{v['ttft_p50_ms']:.1f} ms, itl p50 "
                    f"{v['itl_p50_ms']:.2f} ms" for k, v in out.items()))
    return out


def captured_contiguous_case(engine, captured, layer):
    """Layer ``layer``'s queries of the last prefill wave and decode step
    over its live contiguous cache after the drain (rows the decode
    steps appended lie past every captured query's position)."""
    import torch

    e = engine.model.cfg.energon
    cache = {k: v[layer] for k, v in engine.cache.items()}
    batch, heads, n_k, d = cache["k"].shape
    bh = batch * heads
    q_pre, qpos = captured["prefill"]
    q_dec, cl = captured["decode"]
    dt = cache["k"].dtype
    return ContiguousCase(
        q_dec=q_dec.reshape(bh, -1, d).to(dt).contiguous(),
        cl=cl.to(torch.int32).repeat_interleave(heads),
        q_pre=q_pre.reshape(bh, -1, d).to(dt).contiguous(),
        qpos=qpos.to(torch.int32).repeat_interleave(heads, dim=0),
        k=cache["k"].reshape(bh, n_k, d), v=cache["v"].reshape(bh, n_k, d),
        codes=cache["k_codes"].reshape(bh, n_k, d),
        scale=cache["k_scale"].reshape(bh, -1), bk=e.decode_key_block,
        pk=e.key_block, bq=e.query_block, ratio=e.pruning_ratio,
    )


def random_full_sequence(gen, *, bh=160, n=2048, d=128):
    """bf16 q/k/v ``[bh, n, d]`` at the scoring path's shapes (4
    sequences × 40 heads of 2048 tokens)."""
    import torch

    return [torch.randn((bh, n, d), generator=gen, device=DEV).to(
        torch.bfloat16) for _ in range(3)]


def small_scoring_check():
    """Serve-smoke model in bf16 with impl="pallas" on the card:
    ``LMModel.apply`` logits through B9 + B10 vs the same model with the
    plain versions swapped in (layer 2, the one sparse layer, selects
    bit-exactly, so the logits differ by B10's rounding alone)."""
    import torch

    from repro_torch.configs.registry import get_serve_config
    from repro_torch.kernels import block_sparse_attention as bsa
    from repro_torch.kernels import mpmrf_filter as fk
    from repro_torch.models import LMModel

    cfg = dataclasses.replace(get_serve_config("qwen3-14b", smoke=True),
                              dtype="bfloat16")
    model = LMModel(cfg, device=DEV)
    params = model.init(seed=2)
    gen = torch.Generator(device=DEV).manual_seed(4)
    batch = {"inputs": torch.randint(1, cfg.vocab_size - 1, (2, 128),
                                     generator=gen, device=DEV)}
    fast = model.apply(params, batch)[0]
    swaps = [(fk, "mpmrf_filter_scores"), (bsa, "block_sparse_attention")]
    saved = [(m, n, getattr(m, n)) for m, n in swaps]
    try:
        for m, n in swaps:
            setattr(m, n, getattr(m, n + "_plain"))
        plain = model.apply(params, batch)[0]
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    need(bool(torch.isfinite(fast).all()), "small scoring: non-finite logits")
    diff = fast - plain
    rel = (diff.norm() / plain.norm()).item()
    log(f"[small-score] serve-smoke bf16 apply logits [2, 128, "
        f"{cfg.vocab_size}], kernels vs plain versions: max |err| "
        f"{diff.abs().max().item():.3e}, ‖err‖/‖ref‖ {rel:.3e} (rms "
        f"{plain.pow(2).mean().sqrt().item():.3e})")
    need(rel <= SMALL_REL_TOL,
         f"small scoring logits differ by {rel:.3e} of their norm")


def score_full_width(model, params, *, n_seq=4, seq_len=2048, seed=5):
    """``LMModel.loss`` over ``n_seq`` random sequences at full width, the
    launch counts zeroed just before and read just after; then ``apply``
    for the logits. Returns the results and the q/k/v (``[B·H, n, d]``)
    that the first sparse layer handed to the kernels."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ops

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size - 1,
                                        size=(n_seq, seq_len + 1)),
                           device=DEV)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    captured = {}
    real_bsa = ops.block_sparse_attention

    def capture(q, k, v, *args, **kw):
        captured.setdefault("qkv", (q, k, v))
        return real_bsa(q, k, v, *args, **kw)

    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.block_sparse_attention = capture
    try:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        loss, metrics = model.loss(params, batch)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    finally:
        ops.block_sparse_attention = real_bsa
    peak = mem_gb(torch.cuda.max_memory_allocated)
    sparse_layers = cfg.num_layers - cfg.energon.min_prune_layer
    tokens = n_seq * seq_len
    log(f"[score] {cfg.name} LMModel.loss over {n_seq} × {seq_len} tokens "
        f"({cfg.num_layers} layers, impl {cfg.energon.impl!r}): loss "
        f"{float(loss):.4f} in {wall:.3f} s ({tokens / wall:.1f} tok/s), "
        f"peak device memory {peak} GB")
    log(f"[score] kernel launches: {json.dumps(launches)}")
    need(bool(torch.isfinite(loss)), f"non-finite loss {float(loss)}")
    for name in ("mpmrf_filter_scores", "block_sparse_attention"):
        need(launches[name] == sparse_layers,
             f"{name} launched {launches[name]} times in scoring, not "
             f"{sparse_layers} (layers {cfg.energon.min_prune_layer}–"
             f"{cfg.num_layers - 1})")
    for name in SERVE_KERNELS + UNPAGED_KERNELS + ("flash_attention",):
        need(launches[name] == 0, f"{name} launched in scoring")
    need(float(metrics["tokens"]) == tokens, "loss counted the wrong tokens")

    t0 = time.perf_counter()
    logits, _ = model.apply(params, batch)
    sync()
    apply_wall = time.perf_counter() - t0
    need(tuple(logits.shape) == (n_seq, seq_len, cfg.vocab_size),
         f"logits shape {tuple(logits.shape)}")
    need(bool(torch.isfinite(logits).all()), "non-finite logits")
    log(f"[score] LMModel.apply: logits {tuple(logits.shape)} f32, all "
        f"finite, in {apply_wall:.3f} s (rms "
        f"{logits.pow(2).mean().sqrt().item():.3f})")
    del logits
    out = dict(loss=float(loss), wall_s=wall, tok_s=tokens / wall,
               apply_wall_s=apply_wall, tokens=tokens, peak_memory_gb=peak,
               launches=launches)
    if DEV == "cuda":
        out["profile"] = profile_scoring(model, params, batch)
    return out, captured["qkv"]


def profile_scoring(model, params, batch):
    """One more ``LMModel.loss`` under ``torch.profiler``: device time by
    kernel and the device's idle share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        model.loss(params, batch)
        sync()
        wall = time.perf_counter() - t0
    out = dict(wall_s=wall, **device_split(prof, wall, top=15))
    log(f"[profile-score] LMModel.loss: wall {wall:.3f} s, device busy "
        f"{out['device_busy_s']:.3f} s, idle {out['idle_share']:.1%} "
        f"(under the profiler)")
    for r in out["top"]:
        log(f"[profile-score] {r['device_ms']:10.2f} ms  x{r['calls']:<6d} "
            f"{r['name']}")
    log("[profile-score] the port's kernels: " + ", ".join(
        f"{k} {r['device_ms']:.2f} ms over {r['calls']} calls"
        for k, r in out["port"].items()))
    return out


def time_sparse_pair(q, k, v, *, bq, bk, ratio, layer):
    """The sparse pair (B9 + selection + B10) against B11 on the same
    operands: a measurement to write down, not a claimed speedup."""
    from repro_torch.kernels import ops

    budget = max(1, math.ceil(k.shape[1] // bk / ratio))
    pair = lambda: ops.block_sparse_attention(
        q, k, v, *ops.mpmrf_select_blocks(
            q, k, block_budget=budget, query_block=bq, key_block=bk),
        query_block=bq, key_block=bk)
    dense = lambda: ops.flash_attention(q, k, v)
    out = dict(sparse_pair_ms=time_ms(pair, iters=10),
               flash_ms=time_ms(dense, iters=10))
    log(f"[pair:captured] B9 + selection + B10 {out['sparse_pair_ms']:.4f} "
        f"ms vs B11 {out['flash_ms']:.4f} ms on layer {layer}'s operands")
    return out


def grad_check(*, bh=8, n=512, d=128, bq=128, bk=64, budget=2):
    """``ops.energon_block_attention`` forward and backward on the card:
    the forward equals the mpmrf_select_blocks + block_sparse_attention
    composition, and the gradients equal autograd through the plain
    block-sparse attention with that selection (the backward's own
    recipe, run a second time: its index backward sums with atomics, so
    bf16 grads are held to torch's bf16 tolerance)."""
    import torch

    from repro_torch.kernels import block_sparse_attention as bsa
    from repro_torch.kernels import ops

    gen = torch.Generator(device=DEV).manual_seed(6)
    q, k, v = (torch.randn((bh, n, d), generator=gen, device=DEV).to(
        torch.bfloat16).requires_grad_() for _ in range(3))
    out = ops.energon_block_attention(q, k, v, budget, bq, bk, True)
    kw = dict(query_block=bq, key_block=bk)
    idx, val = ops.mpmrf_select_blocks(q.detach(), k.detach(),
                                       block_budget=budget, **kw)
    want = ops.block_sparse_attention(q.detach(), k.detach(), v.detach(),
                                      idx, val, **kw)
    need(torch.equal(out.detach(), want),
         "energon_block_attention forward differs from its composition")
    g = torch.randn(out.shape, generator=gen, device=DEV).to(out.dtype)
    grads = torch.autograd.grad(out, (q, k, v), g)
    ref = torch.autograd.grad(
        bsa.block_sparse_attention_plain(q, k, v, idx, val, **kw),
        (q, k, v), g)
    errs = []
    for name, a, b in zip("qkv", grads, ref):
        need(bool(torch.isfinite(a).all()), f"non-finite d{name}")
        try:
            torch.testing.assert_close(a, b)
        except AssertionError as exc:
            raise SmokeFailure(f"d{name} differs: {exc}") from None
        errs.append((a.float() - b.float()).abs().max().item())
    log(f"[grad] energon_block_attention [{bh}, {n}, {d}] bf16, budget "
        f"{budget}: forward equal to its composition; dq/dk/dv vs autograd "
        f"through the plain version max |err| "
        + " / ".join(f"{e:.3e}" for e in errs))


#: the sources of the tile-engine kernels, always rebuilt so that nvcc's
#: -Xptxas -v report covers every instantiation
ENGINE_SOURCES = ("mpmrf_decode", "mpmrf_prefill", "block_sparse_attention",
                  "flash_attention")
#: the tile-engine kernels and their instantiations: (head dims, layouts)
ENGINE_KERNELS = {
    "decode_split_kernel": "B2/B6",
    "prefill_gather_kernel": "B4/B8",
    "block_sparse_attention_kernel": "B10",
    "flash_attention_kernel": "B11",
}


def engine_ptxas():
    """Registers and spill bytes of each tile-engine instantiation (B2/B6,
    B4/B8 per head dim and layout, B10, B11 per head dim) from nvcc's
    ``-Xptxas -v`` report; fails on any spill at d 128, the model
    paths' head dim."""
    from repro_torch.kernels import _build

    pat = re.compile(r"Compiling entry function '_Z\d+(\w+?)ILi(\d+)E(Lb([01])E)?")
    out = {}
    for name in ENGINE_SOURCES:
        report = _build.build_info["ptxas"].get(name, "")
        kernel = None
        for line in report.splitlines():
            m = pat.search(line)
            if m and m.group(1) in ENGINE_KERNELS:
                layout = {None: "", "1": ", paged", "0": ", contiguous"}[
                    m.group(4)]
                kernel = f"{m.group(1)}<{m.group(2)}{layout}>"
                out[kernel] = dict(d=int(m.group(2)),
                                   kernel=ENGINE_KERNELS[m.group(1)])
            elif "Compiling entry function" in line:
                kernel = None
            elif kernel and "spill stores" in line:
                st, ld = re.findall(r"(\d+) bytes spill", line)
                out[kernel].update(spill_stores=int(st), spill_loads=int(ld))
            elif kernel and "Used" in line and "registers" in line:
                out[kernel]["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
    need(len(out) == 4 * (2 + 2 + 1 + 1),
         f"ptxas reported {sorted(out)}, not B2/B6 and B4/B8 (paged and "
         f"contiguous), B10 and B11 at d 16, 32, 64 and 128")
    for kernel, r in sorted(out.items()):
        log(f"[ptxas] {r['kernel']} {kernel}: {r.get('registers')} "
            f"registers, spill stores {r.get('spill_stores')} B, loads "
            f"{r.get('spill_loads')} B")
        if r["d"] == 128:
            need(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
                 f"{kernel} spills at d 128")
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
    for name in ENGINE_SOURCES:   # rebuilt, so that ptxas reports them
        _build._lib_path(name).unlink(missing_ok=True)
    secs = _build.build()
    log(f"[build] nvcc built {', '.join(_build.SOURCES)} in {secs:.1f} s "
        f"(parallel, sm_90a)")
    for name, report in _build.build_info["ptxas"].items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas:{name}] {line.strip()}")
    ptxas = engine_ptxas()

    results = {name: [] for name in KERNELS}
    gen = torch.Generator(device=DEV).manual_seed(0)
    check_case(random_case(gen), "random", results)
    small_reference_check()
    from repro_torch.configs.registry import get_serve_config

    cfg = get_serve_config("qwen3-14b")
    if args.layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
        log(f"[serve] depth cut to {args.layers} of {get_serve_config('qwen3-14b').num_layers} layers (width unchanged)")
    engine, prompts, run1, launches, streams1 = serve_full_width(cfg)
    layer = engine.model.cfg.energon.min_prune_layer
    check_case(live_pool_case(engine, prompts, layer), f"live-layer{layer}",
               results)
    prof = profile_drain(engine, prompts[0][:SYSTEM_LEN])

    # the contiguous cache on the same model object and weights; the
    # paged engine (and its page pool) goes first
    model, params = engine.model, engine.params
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    case = random_contiguous_case(gen)
    same_rows = {"random": check_same_rows(
        case, check_contiguous(case, "random", results), "random", gen)}
    check_contiguous(random_contiguous_case(gen, pk=128), "random-kb128",
                     results, timed=False, gather=False)
    del case
    uengine, unpaged, ulaunches, captured = serve_unpaged(
        model, params, prompts, streams1)
    case = captured_contiguous_case(uengine, captured, layer)
    same_rows["captured"] = check_same_rows(
        case, check_contiguous(case, f"captured-layer{layer}", results),
        f"captured-layer{layer}", gen)
    del uengine, case, captured
    gc.collect()
    torch.cuda.empty_cache()
    in_turns = serve_in_turns(model, params, prompts, streams1)

    # full-sequence scoring on the same model object and weights
    e = model.cfg.energon
    blocks = dict(bq=e.query_block, bk=e.key_block, ratio=e.pruning_ratio)
    q, k, v = random_full_sequence(gen)
    random_fs = check_full_sequence(q, k, v, "random", results, **blocks)
    half = q.shape[1] // 2
    check_full_sequence(q[:, half:].contiguous(), k, v, "random-offset",
                        results, q_offset=half, timed=False, **blocks)
    del q, k, v
    small_scoring_check()
    scoring, (q, k, v) = score_full_width(model, params)
    captured_fs = check_full_sequence(q, k, v, f"captured-layer{layer}",
                                      results, **blocks)
    pair = time_sparse_pair(q, k, v, layer=layer, **blocks)
    del q, k, v
    grad_check()

    timed_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, meta in KERNELS.items():
        entries = results[name]
        main_run, rand = entries[-1], entries[0]
        run = (launches if name in SERVE_KERNELS else ulaunches
               if name in UNPAGED_KERNELS else scoring["launches"])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=run[name],
            max_abs_err=max(r["err"] for r in entries),
            **{k: main_run[k] for k in timed_keys},
            **{k: main_run[k] for k in ("device_ms", "library_device_ms")
               if k in main_run},
            ms_over_bound=main_run["ms"] / main_run["bound_ms"],
            random=dict({k: rand[k] for k in ("err",) + timed_keys},
                        ms_over_bound=rand["ms"] / rand["bound_ms"]),
        ))
    log(json.dumps({"serve": run1, "profile": prof, "card": smi}))
    log(json.dumps({"unpaged": dict(unpaged, same_rows=same_rows,
                                     in_turns=in_turns), "card": smi}))
    log(json.dumps({"scoring": dict(scoring, random=random_fs,
                                    captured=captured_fs, **pair),
                    "ptxas": ptxas, "card": smi}))
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

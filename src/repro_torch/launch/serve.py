"""Serving launcher: chunked prefill + batched sparse decode over the
paged KV cache (or, with ``--unpaged``, the contiguous one), on the GPU.

``python -m repro_torch.launch.serve --arch qwen3-14b`` (or any other
arch of the registry: ``starcoder2-7b``, ``gemma3-27b``,
``phi3-mini-3.8b``, ``olmoe-1b-7b``, ``qwen3-moe-235b-a22b``,
``llava-next-34b``, ``musicgen-medium``, ``zamba2-7b``, ``xlstm-1.3b``)
serves synthetic requests at full width (random weights from
``--seed``) through the fused paged kernels (``--unpaged``: their
contiguous twins) and reports prefill and decode throughput and latency
percentiles. The recurrent families (``zamba2-7b``, ``xlstm-1.3b``)
have no chunked prefill and no page pool: they serve from the
contiguous cache, admitting prompts token by token (the header says
``prefill (sequential)``), on one device only. ``--smoke`` uses
the reduced widths; ``--layers`` cuts depth only; ``--device cpu`` runs
the kernels' plain versions.
``--max-len`` and ``--prefill-chunk`` default to shapes on which every
layer runs (4096 / 128 at full width, 128 / 64 at smoke widths; the
longest max_len below 4096 whose dense prefix masks stay within
``chunk_threshold``: 3584 for starcoder2-7b's G = 9; chunks of 64 at
qwen3-moe-235b-a22b's G = 16, so that its max_len stays 4096);
``ServeLoop`` refuses shapes that would leave the fused kernels.
``--deadline-ms``, ``--queue-limit`` and ``--chaos-seed`` exercise the
request lifecycle and fault containment; ``--obs``, ``--metrics-out``
and ``--trace-out`` attach the observability layer (event trace,
metrics registry, sparsity telemetry) and write its JSON snapshot and
Chrome trace. ``--mesh DxM`` serves over a ``(data, model)`` mesh: D
engine replicas behind one queue (``ReplicatedServeLoop``; a lone
tensor-parallel engine for D = 1), each splitting its page pools by KV
head over M devices — and an MoE model's experts, where M divides them
(olmoe-1b-7b, qwen3-moe-235b-a22b: expert parallelism); ``--simulate-
devices N`` makes the mesh's devices N entries of the one device
(``cuda:0`` × N on one card), and is never implied.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import time


def _parse_mesh(spec: str, pod: bool = False):
    """``DxM`` → ``(D, M)``; with ``pod`` also ``PxDxM`` → ``(P, D, M)``
    (the train CLI's three-axis mesh). The serve CLI takes ``DxM`` only,
    as the reference's does: its engines are TP-only replicas."""
    form = r"(\d+)x(\d+)(?:x(\d+))?" if pod else r"(\d+)x(\d+)"
    m = re.fullmatch(form, spec.strip().lower())
    if m is None:
        want = ("DxM or PxDxM (e.g. 2x2, 2x2x2)" if pod else
                "DxM (e.g. 2x2): the serve CLI takes (data, model) meshes")
        raise SystemExit(f"--mesh wants {want}, got {spec!r}")
    return tuple(int(g) for g in m.groups() if g is not None)


def mesh_devices(args, device) -> list:
    """A mesh's devices: ``--simulate-devices`` entries of ``device``,
    else the host's devices of its type."""
    import torch

    if args.simulate_devices is not None:
        return [device] * args.simulate_devices
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _mesh(args, device, pod: bool = False):
    """The ``--mesh`` mesh over the host's devices of ``device``'s type
    (or ``--simulate-devices`` entries of ``device``), or None; ``pod``
    admits a three-axis ``PxDxM`` (``("pod", "data", "model")``)."""
    if args.mesh is None:
        return None
    import math

    from repro_torch.launch.mesh import make_mesh

    shape = _parse_mesh(args.mesh, pod)
    need = math.prod(shape)
    devices = mesh_devices(args, device)
    if len(devices) < need:
        raise SystemExit(
            f"--mesh {args.mesh} needs {need} devices, have {len(devices)} "
            f"(try --simulate-devices {need})")
    return make_mesh(shape, None, devices)


def main(argv=None):
    from repro_torch.configs.registry import ARCH_NAMES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (depth only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; never falls back)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--scheduler", choices=("hybrid", "sync"),
                    default="hybrid")
    ap.add_argument("--admission-lookahead", type=int, default=0,
                    metavar="K")
    ap.add_argument("--unpaged", action="store_true",
                    help="force the contiguous batch×max_len cache")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged pool size (default slots×blocks; smaller "
                         "values oversubscribe and may preempt)")
    ap.add_argument("--no-prefix-sharing", action="store_true")
    ap.add_argument("--system-prompt-len", type=int, default=0,
                    help="prepend this many shared system-prompt tokens")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request TTL in milliseconds: the engine "
                         "evicts an expired request at any state")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bounded admission queue: submissions past this "
                         "depth are rejected (QueueFull)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="run under a seeded FaultInjector (allocation "
                         "denials, step exceptions, NaN logits, "
                         "preemption storms); one seed, one schedule")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace of the run here; "
                         "implies --obs")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics/sparsity JSON snapshot here; "
                         "implies --obs")
    ap.add_argument("--obs", action="store_true",
                    help="attach the observability layer (event trace, "
                         "sparsity telemetry, metrics registry)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve over a (data, model) device mesh, e.g. "
                         "2x2: D engine replicas behind one admission "
                         "queue, each tensor-parallel over M devices "
                         "(page pools split by KV head)")
    ap.add_argument("--simulate-devices", type=int, default=None,
                    metavar="N",
                    help="the mesh's devices are N entries of the one "
                         "device (cuda:0 × N on one card)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs.registry import get_serve_config
    from repro_torch.device import resolve_device
    from repro_torch.models import LMModel
    from repro_torch.runtime import (
        FaultInjector, FaultSpec, QueueFull, ReplicatedServeLoop, Request,
        ServeLoop, attention_cache_bytes,
    )
    from repro_torch.runtime.paged_cache import attention_cache_shard_bytes

    device = resolve_device(args.device)
    mesh = _mesh(args, device)
    cfg = get_serve_config(args.arch, smoke=args.smoke)
    group = cfg.num_heads // cfg.num_kv_heads
    if args.prefill_chunk is None:
        # chunks of 128 at full width, but 64 at G = 16 (qwen3-moe), whose
        # dense prefix would cap max_len at 2048 with 128
        args.prefill_chunk = 64 if args.smoke or group >= 16 else 128
    if args.max_len is None:
        # at most 4096, and within what the dense prefix layers may mask
        # ([G·chunk, max_len] up to chunk_threshold: 3584 for G = 9)
        e = cfg.energon
        fit = e.chunk_threshold // (group * args.prefill_chunk)
        args.max_len = min(128 if args.smoke else 4096,
                           fit // e.decode_key_block * e.decode_key_block)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if device.type == "cuda":
        # the CUDA gather kernels take bf16 K/V (the smoke config is fp32)
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = LMModel(cfg, device=device)
    params = model.init(seed=args.seed)
    obs = None
    if args.obs or args.trace_out or args.metrics_out:
        from repro_torch.observability import Observability

        obs = Observability()
    injector = None
    if args.chaos_seed is not None:
        injector = FaultInjector(seed=args.chaos_seed, spec=FaultSpec(
            alloc_failure=0.05, step_exception=0.05, nan_logits=0.01,
            nan_prefill=0.01, preempt_storm=0.05,
        ))
    engine_kw = dict(
        batch_slots=args.batch_slots, max_len=args.max_len,
        eos_token=cfg.vocab_size - 1, seed=args.seed,
        prefill_chunk=args.prefill_chunk, scheduler=args.scheduler,
        admission_lookahead=args.admission_lookahead,
        paged=False if args.unpaged else None, num_pages=args.num_pages,
        prefix_sharing=(False if (args.no_prefix_sharing or args.unpaged)
                        else None),
        queue_limit=args.queue_limit,
        default_deadline_s=(args.deadline_ms / 1e3
                            if args.deadline_ms is not None else None),
        fault_injector=injector, observability=obs, device=device,
    )
    replicated = mesh is not None and mesh.shape["data"] > 1
    if replicated:
        engine = ReplicatedServeLoop(model, params, mesh=mesh, **engine_kw)
    else:
        engine = ServeLoop(model, params, mesh=mesh, **engine_kw)
    engines = engine.engines if replicated else [engine]
    if mesh is not None:
        d, m = mesh.shape.values()
        print(f"[serve] mesh {d}x{m} (data x model) over "
              f"{len(mesh.physical_devices)} physical "
              f"{mesh.first_device.type} device(s)"
              + (f", {d} engine replicas" if replicated else "")
              + f"; steps {engines[0].graph_mode}")
    engine.capture_graphs()      # before the clock: no request waits
    rng = np.random.default_rng(args.seed)
    system = rng.integers(1, cfg.vocab_size - 1,
                          size=args.system_prompt_len).tolist()
    rejected = 0
    for uid in range(args.requests):
        prompt = system + rng.integers(
            1, cfg.vocab_size - 1, size=args.prompt_len
        ).tolist()
        try:
            engine.submit(Request(uid=uid, prompt=prompt,
                                  max_new_tokens=args.new_tokens))
        except QueueFull:
            rejected += 1
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0
    m = engine.merged_metrics() if replicated else engine.metrics
    eng0 = engines[0]
    total = sum(len(r.tokens_out) for r in done)
    print(f"[serve] {cfg.name} ({cfg.num_layers} layers) on "
          f"{eng0.device}: {len(done)} requests, {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s end-to-end)")
    mode = "chunked" if model.supports_prefill else "sequential"
    print(f"[serve] prefill ({mode}): {m.prefill_tokens} tok in "
          f"{m.prefill_dispatches} dispatches "
          f"({m.prefill_tokens_per_sec:.1f} tok/s)")
    print(f"[serve] decode: {m.decode_tokens} tok in {m.decode_dispatches} "
          f"dispatches ({m.decode_tokens_per_sec:.1f} tok/s, "
          f"{m.ticks} ticks)")
    lat = m.latency_stats()
    print(f"[serve] latency: ttft p50/p95 {lat['ttft_p50'] * 1e3:.1f}/"
          f"{lat['ttft_p95'] * 1e3:.1f} ms, itl p50/p95 "
          f"{lat['itl_p50'] * 1e3:.1f}/{lat['itl_p95'] * 1e3:.1f} ms "
          f"(decode-attributed p95 {lat['itl_decode_p95'] * 1e3:.1f} ms), "
          f"queue p95 {lat['queue_wait_p95'] * 1e3:.1f} ms")
    nbytes = attention_cache_bytes(eng0.cache)
    if eng0.paged:
        shards = attention_cache_shard_bytes(eng0.cache)
        per = " per replica" if replicated else ""
        print(f"[serve] cache (paged): {eng0.layout.num_pages} pages, "
              f"{nbytes} B pool{per}"
              + (f" ({len(shards)} head shards of {shards[0]} B)"
                 if len(shards) > 1 else "")
              + f", peak {m.peak_pages_in_use} pages in use, "
              f"{m.preemptions} preemptions")
    else:
        print(f"[serve] cache (contiguous): {eng0.batch_slots} slots × "
              f"{eng0.max_len} rows, {nbytes} B")
    if replicated:
        counts = [list(engine.placement.values()).count(r)
                  for r in range(engine.n_replicas)]
        print("[serve] replicas: " + " | ".join(
            f"r{e.replica_id}: {counts[e.replica_id]} req, "
            f"{e.metrics.decode_tokens} tok, {e.metrics.ticks} ticks"
            for e in engine.engines))
    if eng0.sharing:
        print(f"[serve] prefix cache: hit-rate {m.prefix_hit_rate:.2f} "
              f"({m.prefix_hits}/{m.prefix_lookups} admissions), "
              f"{m.pages_shared} pages shared, "
              f"{m.prefill_tokens_skipped} prefill tok skipped, "
              f"{m.cow_clones} CoW clones")
    if engine.terminated or rejected or m.retries or injector is not None:
        print(f"[serve] lifecycle: {len(done)} completed, "
              f"{m.failed_requests} failed, {m.cancelled_requests} "
              f"cancelled, {m.expired_requests} expired, "
              f"{m.shed_requests + rejected} shed/rejected, "
              f"{m.retries} step retries")
    if injector is not None:
        print(f"[serve] chaos (seed {args.chaos_seed}): "
              f"{injector.total_injected} faults injected "
              f"{dict(injector.counts)}")
    if obs is not None:
        _report_observability(obs, args)
    return engine


def _report_observability(obs, args) -> None:
    """The sparsity line, and the Chrome trace and metrics snapshot
    where asked for."""
    sp = obs.sparsity.snapshot()
    rho_p, rho_d = sp["prefill"]["rho_eff"], sp["decode"]["rho_eff"]
    pool = obs.series_stats("pool_occupancy")
    print(f"[serve] sparsity: rho_eff prefill "
          f"{'n/a' if rho_p is None else f'{rho_p:.3f}'} / decode "
          f"{'n/a' if rho_d is None else f'{rho_d:.3f}'}"
          + (f" (pinned {sp['decode']['pinned_fraction']:.2f}, "
             f"fill {sp['decode']['fill_fraction']:.2f})"
             if rho_d is not None else "")
          + f", pool occupancy p50/peak {pool['p50']:.0f}/"
            f"{pool['peak']:.0f} pages, {len(obs.trace)} trace events")
    if args.trace_out:
        obs.export_chrome_trace(args.trace_out)
        print(f"[serve] chrome trace -> {args.trace_out} "
              f"(open in ui.perfetto.dev)")
    if args.metrics_out:
        import json

        with open(args.metrics_out, "w") as f:
            json.dump(obs.snapshot(), f, indent=2)
        print(f"[serve] metrics snapshot -> {args.metrics_out}")


if __name__ == "__main__":
    main()

"""Serving launcher: chunked prefill + batched sparse decode over the
paged KV cache, on the GPU.

``python -m repro_torch.launch.serve --arch qwen3-14b`` serves synthetic
requests at full width (random weights from ``--seed``) through the
fused paged kernels and reports prefill and decode throughput and
latency percentiles. ``--smoke`` uses the reduced widths; ``--layers``
cuts depth only; ``--device cpu`` runs the kernels' plain versions.
``--max-len`` and ``--prefill-chunk`` default to shapes on which every
layer runs (4096 / 128 at full width, 128 / 64 at smoke widths);
``ServeLoop`` refuses shapes that would leave the fused kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
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
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged pool size (default slots×blocks; smaller "
                         "values oversubscribe and may preempt)")
    ap.add_argument("--no-prefix-sharing", action="store_true")
    ap.add_argument("--system-prompt-len", type=int, default=0,
                    help="prepend this many shared system-prompt tokens")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs.registry import get_serve_config
    from repro_torch.device import resolve_device
    from repro_torch.models import LMModel
    from repro_torch.runtime import Request, ServeLoop, attention_cache_bytes

    device = resolve_device(args.device)
    if args.max_len is None:
        args.max_len = 128 if args.smoke else 4096
    if args.prefill_chunk is None:
        args.prefill_chunk = 64 if args.smoke else 128
    cfg = get_serve_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if device.type == "cuda":
        # the CUDA gather kernels take bf16 K/V (the smoke config is fp32)
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = LMModel(cfg, device=device)
    params = model.init(seed=args.seed)
    engine = ServeLoop(
        model, params, batch_slots=args.batch_slots, max_len=args.max_len,
        eos_token=cfg.vocab_size - 1, seed=args.seed,
        prefill_chunk=args.prefill_chunk, scheduler=args.scheduler,
        admission_lookahead=args.admission_lookahead,
        num_pages=args.num_pages,
        prefix_sharing=not args.no_prefix_sharing, device=device,
    )
    rng = np.random.default_rng(args.seed)
    system = rng.integers(1, cfg.vocab_size - 1,
                          size=args.system_prompt_len).tolist()
    for uid in range(args.requests):
        prompt = system + rng.integers(
            1, cfg.vocab_size - 1, size=args.prompt_len
        ).tolist()
        engine.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=args.new_tokens))
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0
    m = engine.metrics
    total = sum(len(r.tokens_out) for r in done)
    print(f"[serve] {cfg.name} ({cfg.num_layers} layers) on "
          f"{engine.device}: {len(done)} requests, {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s end-to-end)")
    print(f"[serve] prefill: {m.prefill_tokens} tok in "
          f"{m.prefill_dispatches} dispatches "
          f"({m.prefill_tokens_per_sec:.1f} tok/s)")
    print(f"[serve] decode: {m.decode_tokens} tok in {m.decode_dispatches} "
          f"dispatches ({m.decode_tokens_per_sec:.1f} tok/s, "
          f"{m.ticks} ticks)")
    lat = m.latency_stats()
    print(f"[serve] latency: ttft p50/p95 {lat['ttft_p50'] * 1e3:.1f}/"
          f"{lat['ttft_p95'] * 1e3:.1f} ms, itl p50/p95 "
          f"{lat['itl_p50'] * 1e3:.1f}/{lat['itl_p95'] * 1e3:.1f} ms")
    pool = attention_cache_bytes(engine.cache)
    print(f"[serve] cache (paged): {engine.layout.num_pages} pages, "
          f"{pool} B pool, peak {m.peak_pages_in_use} pages in use, "
          f"{m.preemptions} preemptions")
    if engine.sharing:
        print(f"[serve] prefix cache: hit-rate {m.prefix_hit_rate:.2f} "
              f"({m.prefix_hits}/{m.prefix_lookups} admissions), "
              f"{m.pages_shared} pages shared, "
              f"{m.prefill_tokens_skipped} prefill tok skipped, "
              f"{m.cow_clones} CoW clones")
    return engine


if __name__ == "__main__":
    main()

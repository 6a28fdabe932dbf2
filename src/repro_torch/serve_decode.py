"""Batched serving with Energon MP-MRF decode attention over a paged KV
cache, on the port: the counterpart of the reference's
``examples/serve_decode.py``, with the same config, pool and request
stream.

Continuous batching over a shared page pool: prompts are admitted the
moment enough pages are free (chunked prefill writes whole blocks of
K/V rows through the block table), then every decode step filters the
resident cache with low-bit block scores and gathers only the surviving
pages (the paper's l=1 text-generation pipeline, §IV-D). The pool is
deliberately oversubscribed — fewer pages than slots × blocks — so the
run also exercises eager page frees and youngest-first preemption,
while each request's own sampling stream (the reference's Threefry
keys, :mod:`repro_torch.core.prng`) keeps the mixed greedy / stochastic
traffic deterministic per request. Every request shares one system
prompt, so the prefix cache attaches its pages instead of re-prefilling
them — watch the hit-rate line.

The run is instrumented with the observability layer: typed trace
events (admissions, decode ticks, preemptions, CoW clones), the
per-dispatch survivor-block counts of the MP-MRF selection — the
runtime-effective keep ratio ρ_eff — and per-tick pool / queue series,
exported as a Chrome / Perfetto trace to ``serve_trace.json`` in the
working directory.

    PYTHONPATH=src python -m repro_torch.serve_decode [--device cpu]

It runs on ``cuda`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import EnergonConfig
from repro_torch.device import resolve_device
from repro_torch.models import LMModel
from repro_torch.observability import Observability
from repro_torch.runtime import Request, ServeLoop, attention_cache_bytes

N_REQUESTS = 24


def config() -> ModelConfig:
    """The reference example's model: f32, 4 layers, d 128, 8 / 4
    heads, ``mpmrf_block`` from layer 1 at ρ 2, decode key blocks of
    32."""
    return ModelConfig(
        name="serve-demo", family="dense", num_layers=4, d_model=128,
        num_heads=8, num_kv_heads=4, head_dim=16, d_ff=256,
        vocab_size=512, dtype="float32", remat="none",
        energon=EnergonConfig(impl="mpmrf_block", min_prune_layer=1,
                              pruning_ratio=2.0, decode_key_block=32),
    )


def request_stream(cfg: ModelConfig, n_req: int = N_REQUESTS
                   ) -> List[Dict[str, object]]:
    """The reference's requests (numpy seed 0): a shared 32-token system
    prompt and 6–63 tokens of each request's own, 24 new tokens, odd
    uids at temperature 0.8."""
    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab_size - 1, size=32).tolist()
    out = []
    for uid in range(n_req):
        prompt = system + rng.integers(
            1, cfg.vocab_size - 1, size=int(rng.integers(6, 64))).tolist()
        out.append(dict(uid=uid, prompt=prompt, max_new_tokens=24,
                        temperature=0.8 if uid % 2 else 0.0))
    return out


def main(argv: Optional[Sequence[str]] = None, *, params=None,
         device=None, log: Callable[[str], None] = print
         ) -> Dict[str, object]:
    """Serve the stream and print the reference's lines, asserting what
    it asserts. ``device`` (else ``--device`` from ``argv``, default
    cuda) and ``params`` (default ``model.init(0)``) let a caller pass
    them in; returns ``lines`` (what was printed), ``done``, ``engine``
    and ``obs``."""
    if device is None:
        ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
        ap.add_argument("--device", default=None,
                        help="torch device (default cuda)")
        device = ap.parse_args(argv).device
    dev = resolve_device(device)
    lines: List[str] = []

    def say(line: str) -> None:
        lines.append(line)
        log(line)

    cfg = config()
    model = LMModel(cfg, device=dev)
    if params is None:
        params = model.init(0)

    # 8 slots × 5 blocks of 32 would need 40 pages; 20 oversubscribes
    # the pool so admission is page-driven and exhaustion preempts.
    obs = Observability()
    engine = ServeLoop(model, params, batch_slots=8, max_len=160,
                       eos_token=cfg.vocab_size - 1, prefill_chunk=16,
                       num_pages=20, observability=obs, device=dev)
    assert engine.paged
    for r in request_stream(cfg):
        engine.submit(Request(**r))

    t0 = time.perf_counter()
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0
    m = engine.metrics
    total = sum(len(r.tokens_out) for r in done)
    pool = attention_cache_bytes(engine.cache)
    page = pool // engine.layout.num_pages
    say(f"[serve] {len(done)}/{N_REQUESTS} requests, {total} tokens in "
        f"{dt:.1f}s ({total / dt:.1f} tok/s end-to-end)")
    say(f"[serve] {m.summary()}")
    say(f"[serve] pool: {engine.layout.num_pages} pages × {page} B, "
        f"peak {m.peak_pages_in_use} in use, {m.preemptions} preemptions")
    say(f"[serve] prefix cache: hit-rate {m.prefix_hit_rate:.2f}, "
        f"{m.pages_shared} pages shared, "
        f"{m.prefill_tokens_skipped} prefill tok skipped, "
        f"{m.cow_clones} CoW clones")
    say(f"[serve] sample continuation (greedy): "
        f"{done[0].tokens_out[:12]}")
    sp = obs.sparsity.snapshot()
    rho_d = sp["decode"]["rho_eff"]
    rho_p = sp["prefill"]["rho_eff"]
    pool_s = obs.series_stats("pool_occupancy")
    say(f"[obs] rho_eff decode "
        f"{'n/a' if rho_d is None else f'{rho_d:.3f}'} "
        f"(pinned {sp['decode']['pinned_fraction']:.2f}, "
        f"fill {sp['decode']['fill_fraction']:.2f}), prefill "
        f"{'n/a' if rho_p is None else f'{rho_p:.3f}'}")
    say(f"[obs] pool occupancy p50/peak "
        f"{pool_s['p50']:.0f}/{pool_s['peak']:.0f} pages, "
        f"{len(obs.trace)} trace events "
        f"({obs.trace.dropped} dropped)")
    obs.export_chrome_trace("serve_trace.json")
    say("[obs] chrome trace -> serve_trace.json "
        "(open in ui.perfetto.dev)")
    assert len(done) == N_REQUESTS
    assert m.prefill_dispatches < m.prefill_tokens, \
        "chunked prefill should batch prompt tokens into few dispatches"
    assert m.peak_pages_in_use <= engine.layout.num_pages
    assert rho_d is not None and 0.0 < rho_d <= 1.0
    return dict(lines=lines, done=done, engine=engine, obs=obs)


if __name__ == "__main__":
    main()

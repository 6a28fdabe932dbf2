"""Serving cells: ``ServeLoop.submit`` + ``ServeLoop.tick``, the graphed
paged engine, under an open loop of arrivals or a closed loop of
sessions.

Set-up makes the weights from the seed, builds the engine at the mix's
shape and captures its graphs, then serves what the mix's arrival
process (``perfbench/arrivals/<loop>.py``) asks for in set-up: in an
open loop one greedy and one sampled request that carry the shared
prefix, in a closed loop each session's document (so those pages are
cached, and every path the window takes has run once). The pre-roll's
requests then fill the slots, and the window measures from its start
for ``--seconds``. After the window the loop sends nothing more and
keeps stepping until every request due in the window has its first
token (at most ``grace_s``): a late token is late, and its wait is
counted. A request that a completion releases (a closed loop's next
turn) is due when that completion was seen.

The check takes finished greedy requests drawn from the seed, frees the
program, re-makes the weights and holds every served token against the
float32 reference's logits at its position.
"""

from __future__ import annotations

import gc
import heapq
import sys
import time
from typing import Dict, List, Optional

from perfbench.harness import port, traffic, weights
from perfbench.harness.record import RequestRecord, Run, TickRecord
from perfbench.harness.trace import Tracer, span
from perfbench.harness.verdict import verdict

TERMINAL = ("done", "cancelled", "expired", "failed", "shed")
ENGINE_COUNTERS = ("prefill_tokens", "prefill_dispatches", "decode_tokens",
                   "decode_dispatches")


def _counters(engine) -> Dict[str, float]:
    m = engine.metrics
    out = {k: float(getattr(m, k)) for k in ENGINE_COUNTERS}
    out.update(prefill_time=m.prefill_time, decode_time=m.decode_time)
    return out


class Serving:
    """One serving cell's engine, set up once: weights from the seed, the
    engine at the mix's shape, its graphs captured, and one greedy and
    one sampled request with the shared prefix served."""

    def __init__(self, spec: Dict, mix: Dict, *, seed: int, device,
                 smoke_layers: Optional[int] = None):
        import torch

        from repro_torch.models import LMModel
        from repro_torch.runtime import Request, ServeLoop

        cfg = port.model_config(spec, smoke_layers)
        if smoke_layers is not None:
            spec = port.smoke_spec(cfg, spec["registry"])
        self.spec, self.mix, self.seed, self.device = spec, mix, seed, device
        self.dtype = getattr(torch, cfg.dtype)
        self.Request = Request
        eng = mix["engine"]
        self.tree = weights.make(spec, seed, device, self.dtype)
        self.model = LMModel(cfg, device=device)
        self.engine = ServeLoop(
            self.model, self.tree, batch_slots=eng["batch_slots"],
            max_len=eng["max_len"], prefill_chunk=eng["prefill_chunk"],
            num_pages=eng.get("num_pages"),
            scheduler=eng["scheduler"], prefix_sharing=eng["prefix_sharing"],
            eos_token=-1, seed=seed, device=device)
        self.engine.capture_graphs()
        self.process = traffic.process(mix, seed, spec["vocab_size"],
                                       eng["max_len"])
        for a in self.process.setup:
            self.engine.submit(Request(uid=a.uid, prompt=a.prompt,
                                       max_new_tokens=a.max_new_tokens,
                                       temperature=a.temperature))
        self.cached = self.process.cached
        self.engine.run_until_drained()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.shape = dict(slots=eng["batch_slots"],
                          chunk=self.engine.prefill_chunk,
                          cache_rows=self.engine.max_len)

    def busy(self) -> bool:
        e = self.engine
        return bool(e.pending) or any(s is not None for s in e.slots)

    def window(self, mix: Dict, seconds: float, trace: bool,
               uid0: int = 0):
        """Serve ``mix``'s requests for its pre-roll and ``seconds`` of
        window, then until every request due in the window has its first
        token (at most ``grace_s``). Returns the run's record and the
        finished requests.

        With ``trace`` the engine's counters and the steps' rows are
        read over the window's steady stretch before the profiler starts
        (``rec.engine``, ``rec.steady_ticks``), which the profiler never
        slows; the profiled span keeps its own steps (``rec.ticks``) for
        the metrics that read the device trace."""
        engine, Request = self.engine, self.Request
        rec = Run(kind="serve", spec=self.spec, mix=mix, seconds=seconds,
                  shape=dict(self.shape))
        proc = self.process
        pending: List[tuple] = []             # (due, uid, arrival) unsent
        made = 0                              # arrivals made so far
        watch: Dict[int, None] = {}           # sent, not yet completed

        def add(new):
            nonlocal made
            for a in new:
                heapq.heappush(pending, (a.due, a.uid, a))
            made += len(new)

        add(proc.start(mix, seconds))
        records: Dict[int, RequestRecord] = {}
        reqs: Dict[int, object] = {}

        def on_token(req, tok):
            records[req.uid].token_times.append(time.perf_counter())

        tracer = Tracer(self.device) if trace else None
        tr = mix["trace"]
        chunks: Dict[int, int] = {}          # prefill chunks run, per uid
        jobs_of = {"steady": [], "traced": []}  # each kept tick's (uid, k)
        ticks_of = {"steady": rec.steady_ticks, "traced": rec.ticks}
        phase = "pre"                         # pre, steady, traced, after
        inflight: Dict[int, object] = {}
        t0 = time.perf_counter() + float(mix["preroll_s"])
        t1 = t0 + seconds
        c0: Dict[str, float] = {}

        def step():
            before = ({u: len(records[u].token_times) for u in inflight}
                      if trace else None)
            with span("perfbench.tick"):
                engine.tick()
            if not trace:
                return
            tick = TickRecord()
            jobs = []
            for u, req in list(inflight.items()):
                got = len(records[u].token_times)
                for j in range(before[u], got):
                    if j == 0:
                        jobs.append((u, chunks.get(u, 0)))
                        chunks[u] = chunks.get(u, 0) + 1
                    else:
                        tick.decode_lengths.append(records[u].prompt_len + j)
                if req.state == "prefill":
                    jobs.append((u, chunks.get(u, 0)))
                    chunks[u] = chunks.get(u, 0) + 1
                if req.state in TERMINAL:
                    del inflight[u]
            if phase in ticks_of:
                ticks_of[phase].append(tick)
                jobs_of[phase].append(jobs)

        def release():
            """Hand the process every sent request that has completed
            since the last step, and queue what each releases."""
            now = time.perf_counter() - t0
            for u in [u for u in watch
                      if reqs[uid0 + u].state in TERMINAL]:
                del watch[u]
                add(proc.released(u, now, made))

        tr_start = t0 + tr["start_frac"] * seconds

        def trace_edge(now):
            nonlocal phase
            if phase == "pre" and now >= t0:
                c0.update(_counters(engine))
                phase = "steady"
            if phase == "steady" and now >= tr_start:
                rec.engine = {k: v - c0[k]
                              for k, v in _counters(engine).items()}
                tracer.start()
                phase = "traced"
            elif phase == "traced" and now >= tracer.t0 + tr["length_s"]:
                tracer.stop()
                phase = "after"

        next_probe = t0
        while True:
            now = time.perf_counter()
            with span("perfbench.submit"):
                while pending and t0 + pending[0][0] <= now:
                    a = heapq.heappop(pending)[2]
                    uid = uid0 + a.uid
                    req = Request(uid=uid, prompt=a.prompt,
                                  max_new_tokens=a.max_new_tokens,
                                  temperature=a.temperature,
                                  on_token=on_token)
                    records[uid] = RequestRecord(
                        uid=uid, due=t0 + a.due, prompt_len=len(a.prompt),
                        temperature=a.temperature, cached=self.cached)
                    reqs[uid] = inflight[uid] = req
                    watch[a.uid] = None
                    engine.submit(req)
            if now >= t1:
                break
            if now >= next_probe:
                rec.backlog.append((now - t0, len(engine.pending)))
                next_probe += 0.5
            if tracer is not None:
                trace_edge(now)
            if self.busy():
                step()
                release()
            elif pending:
                with span("perfbench.wait"):
                    time.sleep(max(0.0, min(t0 + pending[0][0] - now,
                                            t1 - now, 0.002)))
        if tracer is not None and tracer.active:
            tracer.stop()
        due = [u for u, r in records.items() if t0 <= r.due < t1]
        t_grace = t1 + float(mix["grace_s"])
        while (any(not records[u].token_times for u in due)
               and time.perf_counter() < t_grace and self.busy()):
            step()
        rec.censor_time = time.perf_counter()
        for u, r in records.items():
            r.state = reqs[u].state
        rec.window = (t0, t1)
        rec.requests = [records[u] for u in sorted(records)]
        if tracer is not None and tracer.done:
            tracer.reduce()
        rec.tracer = tracer
        for name in ticks_of:
            _prefill_rows(rec, ticks_of[name], jobs_of[name], chunks)
        done = [reqs[u] for u in sorted(reqs) if reqs[u].done]
        return rec, done

    def clear(self) -> None:
        """Cancel whatever is still queued or in flight (between sweep
        windows)."""
        e = self.engine
        for uid in [r.uid for r in e.pending] + [
                r.uid for r in e.slots if r is not None]:
            e.cancel(uid)

    def close(self) -> None:
        """Free the program's state."""
        import torch

        del self.engine, self.model, self.tree
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(spec: Dict, mix: Dict, limits: Dict, *, seed: int, seconds: float,
        trace: bool, device, t_start: float,
        smoke_layers: Optional[int] = None, control: bool = False) -> Dict:
    """One run of a serving cell. ``control`` (never set by the
    benchmark's own runs) also reads the fp8 control's numbers."""
    import torch

    cell = Serving(spec, mix, seed=seed, device=device,
                   smoke_layers=smoke_layers)
    # what set-up built lives to the end: keep the collector from
    # walking it again in the window, where a pass stalls the loop
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    try:
        rec, done = cell.window(mix, seconds, trace)
    finally:
        gc.unfreeze()
    rec.setup_s = setup_s
    m = cell.engine.metrics
    print(f"perfbench: prefix cache hits {m.prefix_hits} of "
          f"{m.prefix_lookups} lookups", file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    due = [r for r in rec.requests if rec.in_window(r.due)]
    failed = sum(1 for r in due
                 if r.state in TERMINAL[1:] or not r.token_times)
    chk = mix["check"]
    sample = traffic.check_sample(done, seed, chk["min_served_tokens"],
                                  chk["max_requests"])
    seqs = [(list(r.prompt), list(r.tokens_out)) for r in sample]
    spec, dtype, shape = cell.spec, cell.dtype, cell.shape
    del done, sample
    cell.close()
    gaps, low = reference_gaps(spec, seed, device, dtype, seqs,
                               shape["chunk"], shape["cache_rows"],
                               control=control)
    numbers = gap_numbers(gaps)
    checks, correct = verdict(numbers, limits)
    out = dict(run=rec, correct=correct, attempted=len(due), failed=failed,
               memory_peak_bytes=int(peak), checks=checks, numbers=numbers)
    if control:
        out["control"] = gap_numbers(low)
        out["control_checks"], out["control_correct"] = verdict(
            out["control"], limits)
    return out


def gap_numbers(gaps) -> Dict[str, float]:
    """What the check can compare of the served tokens' gaps below the
    reference's best: the widest, the mean (which grows with the square
    of the logits' error: a token flips more often and by more), the
    share of tokens not the reference's best, and how many there were."""
    if gaps is None or gaps.numel() == 0:
        return {"widest_gap": float("inf"), "mean_gap": float("inf"),
                "flipped_share": 1.0, "tokens_checked": 0}
    return {"widest_gap": float(gaps.max()),
            "mean_gap": float(gaps.double().mean()),
            "flipped_share": float((gaps > 0).double().mean()),
            "tokens_checked": int(gaps.numel())}


def _prefill_rows(rec: Run, ticks: List[TickRecord], tick_jobs: List[List],
                  chunks: Dict[int, int]) -> None:
    """Each kept prefill chunk's rows. A request's first chunk starts at
    the prefix the cache skipped, on the chunk grid: from its prompt and
    its number of chunks where its prefill finished, else the grid
    position of the prefix the cache held."""
    c = rec.shape["chunk"]
    by_uid = {r.uid: r for r in rec.requests}
    for tick, jobs in zip(ticks, tick_jobs):
        for uid, k in jobs:
            r = by_uid[uid]
            p = r.prompt_len
            if r.token_times:
                skip = c * ((p - 1) // c - chunks[uid] + 1)
            else:
                skip = (min(r.cached, p - 1) // c) * c
            lo = skip + c * k
            tick.prefill_rows.append((lo, min(lo + c, p)))
            tick.prefill_finishing += lo + c >= p


def reference_gaps(spec: Dict, seed: int, device, dtype, seqs, chunk: int,
                   cache_rows: int, control: bool = False):
    """How far each served token of ``seqs`` ``[(prompt, served)]`` lies
    below the reference's best logit at its position (one flat tensor),
    and with ``control`` how far the tokens the fp8 control puts first
    there lie (else None)."""
    import torch

    from perfbench.reference import model as R

    if not seqs:
        return None, None
    rc = R.RefConfig.from_file(spec)
    low_gaps = None
    with R.exact_float32():
        tree = weights.make(spec, seed, device, dtype)
        w = R.Weights(tree)
        served = [R.Served(p, s) for p, s in seqs]
        ref = R.serve_logits(rc, w, served, chunk=chunk,
                             cache_rows=cache_rows, device=device)
        gaps = torch.cat([R.token_gaps(lg, s.served)
                          for lg, s in zip(ref, served)]).cpu()
        if control:
            low = R.serve_logits(rc, w, served, chunk=chunk,
                                 cache_rows=cache_rows, device=device,
                                 precision="fp8")
            low_gaps = torch.cat([R.token_gaps(lg, lw.argmax(-1).tolist())
                                  for lg, lw in zip(ref, low)]).cpu()
        del tree, w, ref
    return gaps, low_gaps

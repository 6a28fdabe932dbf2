"""Serving runtime (port of ``repro.runtime.serve_loop``): a
continuous-batching chunked-prefill → sparse-decode engine over the
shared page pool.

* **Paged pool**: a request is admitted the moment enough pages are free
  for its prompt; decode grows a slot one page at a time; on exhaustion
  the youngest live slot is preempted (pages freed, request requeued at
  the front and re-prefilled on re-admission). Allocation is host-side
  and deterministic.
* **Prefix sharing**: admission attaches the longest cached prefix from
  the allocator's trie by block-table aliasing; writes into shared or
  registered pages go through copy-on-write; skipped prefill stays on
  the ``prefill_chunk`` grid so sharing never changes a stream.
* **Hybrid tick** (default): each tick dispatches at most one prefill
  chunk covering every mid-prefill slot, then the decode step over
  decode-state slots. ``scheduler="sync"`` runs a whole admission wave
  inline. Both give the same per-uid streams.
* **Sampling**: greedy, or temperature sampling from a counter-based
  per-request generator seeded from ``(seed, uid, tokens sampled so
  far)`` — independent of batch neighbours and of preemption, which is
  what makes hybrid ≡ sync and preempted ≡ ample-pool hold in-port.
  (The reference's ``jax.random`` streams are not reproduced; greedy
  streams are what compares across the two packages.)
* **Metrics**: prefill and decode tok/s, TTFT and inter-token latency
  percentiles, preemptions, page watermark and prefix-cache counters.

Fault injection, retry, deadlines, cancel, load shedding, observability
and the device mesh wait for later slices of the port.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.energon_attention import paged_serving_faults
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.runtime.paged_cache import PageAllocator, PagedLayout
from repro_torch.runtime.pending import PendingQueue


class EngineStalled(RuntimeError):
    """A tick made no progress with work still queued (e.g. a prompt
    needing more pages than the pool can ever free); ``uids`` names the
    stuck requests."""

    def __init__(self, msg: str, uids: List[int]):
        super().__init__(msg)
        self.uids = list(uids)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    #: admission rank: higher admits first
    priority: int = 0
    #: fairness domain: tenants of one priority class take turns
    tenant: str = ""
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: pending → prefill → decode (→ preempted → prefill …) → done
    state: str = "new"
    _next_input: int = 0
    _submit_seq: int = -1
    _t_submit: Optional[float] = None
    _t_admit: Optional[float] = None
    _t_first: Optional[float] = None
    _t_last: Optional[float] = None
    _itl: "deque[float]" = dataclasses.field(
        default_factory=lambda: deque(maxlen=512)
    )


def _pct(vals: List[float], p: float) -> float:
    return float(np.percentile(np.asarray(vals), p)) if vals else 0.0


class EngineMetrics:
    """Prefill and decode throughput measured separately, per-request
    latency records, and the paged scheduler's counters."""

    def __init__(self, max_request_records: int = 1024):
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.ticks = 0
        self.preemptions = 0
        self.peak_pages_in_use = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.pages_shared = 0
        self.prefill_tokens_skipped = 0
        self.cow_clones = 0
        #: sampled slots whose logits held a NaN/Inf
        self.nonfinite_logits = 0
        self.prefill_time = 0.0
        self.decode_time = 0.0
        self.requests_recorded = 0
        self.request_records: "deque[Dict[str, Any]]" = deque(
            maxlen=max_request_records
        )

    @property
    def prefill_tokens_per_sec(self) -> float:
        return self.prefill_tokens / max(self.prefill_time, 1e-9)

    @property
    def decode_tokens_per_sec(self) -> float:
        return self.decode_tokens / max(self.decode_time, 1e-9)

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(self.prefix_lookups, 1)

    def record_request(self, req: Request) -> None:
        if req._t_submit is None:
            return
        qw = (req._t_admit - req._t_submit) if req._t_admit is not None else 0.0
        ttft = (req._t_first - req._t_submit) if req._t_first is not None else 0.0
        self.request_records.append({
            "uid": req.uid, "queue_wait": qw, "ttft": ttft,
            "itl": list(req._itl),
        })
        self.requests_recorded += 1

    def latency_stats(self) -> Dict[str, float]:
        """p50/p95 of queue wait, TTFT and inter-token latency (s)."""
        qw = [r["queue_wait"] for r in self.request_records]
        tt = [r["ttft"] for r in self.request_records]
        itl = [x for r in self.request_records for x in r["itl"]]
        return {
            "requests": float(self.requests_recorded),
            "queue_wait_p50": _pct(qw, 50), "queue_wait_p95": _pct(qw, 95),
            "ttft_p50": _pct(tt, 50), "ttft_p95": _pct(tt, 95),
            "itl_p50": _pct(itl, 50), "itl_p95": _pct(itl, 95),
        }


def sampling_seed(seed: int, uid: int, n_sampled: int) -> int:
    """Counter-based seed of request ``uid``'s ``n_sampled``-th draw."""
    h = (seed * 0x9E3779B1 + uid) & 0xFFFFFFFFFFFF
    h = (h * 0x85EBCA77 + n_sampled) & 0xFFFFFFFFFFFF
    return h ^ (h >> 17)


@dataclasses.dataclass
class _PrefillJob:
    """One slot's in-flight chunked prefill under the hybrid scheduler."""

    req: Request
    seq: List[int]
    resumed: bool
    skip: int
    pos: int


class ServeLoop:
    """Continuous-batching chunked-prefill / sparse-decode engine over
    the paged KV cache, on ``device`` (``cuda`` unless given)."""

    def __init__(
        self,
        model,
        params,
        *,
        batch_slots: int = 8,
        max_len: int = 512,
        eos_token: int = 0,
        seed: int = 0,
        prefill_chunk: int = 64,
        scheduler: str = "hybrid",
        admission_lookahead: int = 0,
        num_pages: Optional[int] = None,
        prefix_sharing: bool = True,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device}, engine on {self.device}"
            )
        if not model.supports_paged:
            raise NotImplementedError(
                "this slice of the port serves from the paged pool only"
            )
        self.model = model
        self.params = params
        self.batch_slots = batch_slots
        self.sharing = bool(prefix_sharing)
        bk = model.cfg.energon.decode_key_block
        rows = max(-(-model.decode_cache_len(max_len) // bk), 2) * bk
        self.max_len = rows
        self.eos = eos_token
        self.seed = seed
        self.prefill_chunk = max(1, min(prefill_chunk, max_len))
        cfg = model.cfg
        faults = paged_serving_faults(
            cfg.energon, group=cfg.num_heads // cfg.num_kv_heads,
            cache_len=rows, chunk=self.prefill_chunk,
        )
        if faults:
            raise ValueError(
                f"max_len {max_len} / prefill_chunk {prefill_chunk} would "
                "leave the paged serving path: " + "; ".join(faults)
            )
        if scheduler not in ("hybrid", "sync"):
            raise ValueError(
                f"scheduler must be 'hybrid' or 'sync', got {scheduler!r}"
            )
        self.scheduler = scheduler
        self._hybrid = scheduler == "hybrid"
        self.admission_lookahead = max(0, int(admission_lookahead))
        self._prefill_jobs: Dict[int, _PrefillJob] = {}
        mb = rows // bk
        if num_pages is None:
            num_pages = batch_slots * mb
        self.layout = PagedLayout(
            num_pages=num_pages, page_size=bk, max_blocks=mb,
            batch_slots=batch_slots,
        )
        self.allocator = PageAllocator(self.layout)
        self.cache = model.init_paged_cache(num_pages, max_len=self.max_len)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self._temps = np.zeros((batch_slots,), np.float32)
        self._lengths = np.zeros((batch_slots,), np.int64)
        self._slot_order: List[Optional[int]] = [None] * batch_slots
        self._admit_seq = itertools.count()
        self._submit_seq = itertools.count()
        self.pending = PendingQueue()
        self.completed: List[Request] = []
        self.metrics = EngineMetrics()

    # --- API -----------------------------------------------------------
    def submit(self, req: Request):
        if len(req.prompt) > self.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens does not fit the "
                f"{self.max_len} cache rows"
            )
        if req._t_submit is None:
            req._t_submit = time.perf_counter()
        req._submit_seq = next(self._submit_seq)
        req.state = "pending"
        self.pending.append(req)

    # --- device helpers --------------------------------------------------
    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _cache_index(self) -> torch.Tensor:
        return self._tensor(self._lengths)

    def _reset_pages(self, pages: List[int]):
        self.model.reset_pages(
            self.cache, self.allocator.page_reset_mask(pages, self.device)
        )

    def _sample(self, logits: torch.Tensor, mask: np.ndarray):
        """Sample one token for each ``mask`` slot from ``logits [B, V]``:
        argmax at temperature ≤ 0, else a draw from the slot's request
        stream. Returns the host tokens; slots whose logits hold a
        NaN/Inf are counted in ``metrics.nonfinite_logits``."""
        toks = torch.argmax(logits, dim=-1)
        finite = torch.isfinite(logits).all(dim=-1)
        for i in np.nonzero(mask)[0]:
            temp = float(self._temps[i])
            if temp <= 0.0:
                continue
            req = self.slots[i]
            gen = torch.Generator(device=self.device).manual_seed(
                sampling_seed(self.seed, req.uid, len(req.tokens_out))
            )
            probs = torch.softmax(logits[i].float() / max(temp, 1e-6), -1)
            toks[i] = torch.multinomial(probs, 1, generator=gen)[0]
        out = torch.stack([toks.to(torch.int64), finite.to(torch.int64)])
        toks_h, finite_h = out.cpu().numpy()
        self.metrics.nonfinite_logits += int((finite_h == 0)[mask].sum())
        return toks_h

    # --- admission -----------------------------------------------------
    def _plan_prefix_attach(self, seq_tokens: List[int], resumed: bool):
        """Longest cached prefix: ``(skip, attach_pages, clone_src)``.
        Recomputed chunks stay on the ``prefill_chunk`` grid (prefill
        selection pools per query block); a fresh request keeps its last
        token to seed sampling; a resumed one whose match covers all it
        wrote restores by aliasing alone."""
        matched = self.allocator.match_prefix(seq_tokens)
        if not matched:
            return 0, [], None
        bk = self.layout.page_size
        if resumed:
            skip = min(len(matched) * bk, len(seq_tokens))
            if skip < len(seq_tokens):
                skip = (skip // self.prefill_chunk) * self.prefill_chunk
        else:
            skip = min(len(matched) * bk, len(seq_tokens) - 1)
            skip = (skip // self.prefill_chunk) * self.prefill_chunk
        if skip <= 0:
            return 0, [], None
        n_attach = skip // bk
        clone_src = matched[n_attach] if skip % bk else None
        return skip, matched[:n_attach], clone_src

    def _admit(self):
        """Fill free slots from the queue in admission-policy order;
        under the hybrid scheduler this only allocates and enqueues
        prefill jobs, under sync the whole wave runs here."""
        chunked, sequential = [], []
        new_pages: List[int] = []
        now = time.perf_counter()
        free = [i for i in range(self.batch_slots) if self.slots[i] is None]
        candidates = (
            self.pending.admission_order(len(free) + self.admission_lookahead)
            if free and self.pending else []
        )
        misses = 0
        cand_iter = iter(candidates)
        for i in free:
            req = next(cand_iter, None)
            admitted = False
            while req is not None:
                if self._try_admit(i, req, now, new_pages, chunked,
                                   sequential):
                    admitted = True
                    break
                misses += 1
                if misses > self.admission_lookahead:
                    break
                req = next(cand_iter, None)
            if not admitted:
                break
        if new_pages:
            self._reset_pages(new_pages)
        self.metrics.peak_pages_in_use = self.allocator.peak_pages_in_use
        for i, req in sequential:
            # a one-token prompt writes nothing before its first decode
            req._next_input = req.prompt[-1] if req.prompt else self.eos
            req.state = "decode"
        if chunked:
            if self._hybrid:
                self._enqueue_prefill_jobs(chunked)
            else:
                self._prefill_slots(chunked)

    def _try_admit(self, i: int, req: Request, now: float,
                   new_pages: List[int], chunked: List,
                   sequential: List) -> bool:
        """Prefix attach then page allocation for ``req`` into slot
        ``i``, with full rollback when the pool cannot cover it."""
        resumed = bool(req.tokens_out)
        seq_tokens = req.prompt + req.tokens_out[:-1] if resumed else req.prompt
        use_chunked = resumed or len(req.prompt) > 1
        skip, attach, clone_src = 0, [], None
        if self.sharing and use_chunked and len(seq_tokens) > 1:
            skip, attach, clone_src = self._plan_prefix_attach(
                seq_tokens, resumed
            )
        pair = None
        for p in attach:
            self.allocator.share(i, p)
        if clone_src is not None:
            self.allocator.share(i, clone_src)
            pair = self.allocator.cow(i, len(attach))
            if pair is not None:
                # copy now: the source just dropped to refcount 0 and a
                # later allocation in this pass could evict it
                self.model.clone_pages(self.cache, [pair[0]], [pair[1]])
        pages = None
        if clone_src is None or pair is not None:
            pages = self.allocator.ensure_capacity(i, max(len(seq_tokens), 1))
        if pages is None:
            self.allocator.free_slot(i)
            return False
        new_pages += pages
        if self.sharing and use_chunked and len(seq_tokens) > 1:
            self.metrics.prefix_lookups += 1
        if pair is not None:
            self.metrics.cow_clones += 1
        if skip > 0:
            self.metrics.prefix_hits += 1
            self.metrics.pages_shared += len(attach) + (clone_src is not None)
            self.metrics.prefill_tokens_skipped += skip
        self.pending.remove(req.uid)
        self.pending.note_admitted(req)
        self.slots[i] = req
        req.state = "prefill"
        self._slot_order[i] = next(self._admit_seq)
        if req._t_admit is None:
            req._t_admit = now
        self._temps[i] = req.temperature
        self._lengths[i] = 0
        if resumed:
            if seq_tokens:
                chunked.append((i, req, seq_tokens, True, skip))
            else:
                req.state = "decode"
        elif use_chunked:
            chunked.append((i, req, seq_tokens, False, skip))
        else:
            sequential.append((i, req))
        return True

    def _enqueue_prefill_jobs(self, admitted):
        for i, req, seq, resumed, skip in admitted:
            if skip >= len(seq):
                # fully covered resume: restored by table aliasing alone
                self._lengths[i] = len(seq)
                if self.sharing:
                    self.allocator.register_prefix(i, seq)
                req.state = "decode"
            else:
                self._prefill_jobs[i] = _PrefillJob(
                    req=req, seq=seq, resumed=resumed, skip=skip, pos=skip,
                )

    def _dispatch_prefill(self, toks, pos):
        inputs = {
            "tokens": self._tensor(toks),
            "positions": self._tensor(pos),
            "block_table": self.allocator.table_device(self.device),
        }
        logits, self.cache = self.model.prefill(
            self.params, self.cache, inputs, self._cache_index()
        )
        self.metrics.prefill_dispatches += 1
        return logits

    def _prefill_slots(self, admitted):
        """Synchronous wave: chunk c of every admitted prompt rides one
        dispatch; a fresh slot's first token is sampled off its final
        chunk."""
        C = self.prefill_chunk
        t0 = time.perf_counter()
        n_chunks = max(
            -(-(len(seq) - skip) // C) for _, _, seq, _, skip in admitted
        )
        last_logits = {}
        for c in range(n_chunks):
            toks = np.zeros((self.batch_slots, C), np.int32)
            pos = np.full((self.batch_slots, C), self.max_len, np.int32)
            for i, req, seq, _, skip in admitted:
                lo = skip + c * C
                part = seq[lo:lo + C]
                if part:
                    toks[i, :len(part)] = part
                    pos[i, :len(part)] = lo + np.arange(len(part))
            logits = self._dispatch_prefill(toks, pos)
            for i, req, seq, resumed, skip in admitted:
                lo = skip + c * C
                if not resumed and lo < len(seq) <= lo + C:
                    last_logits[i] = logits[i, len(seq) - 1 - lo]
        synchronize(self.device)
        for i, req, seq, _, skip in admitted:
            self._lengths[i] = len(seq)
            self.metrics.prefill_tokens += len(seq) - skip
        self.metrics.prefill_time += time.perf_counter() - t0
        self._complete_prefill(admitted, last_logits)

    def _complete_prefill(self, entries, last_logits):
        """Sample every fresh finishing slot's first token, register the
        filled pages in the prefix trie, commit, flip to decode."""
        toks = None
        if last_logits:
            zero_row = torch.zeros_like(next(iter(last_logits.values())))
            logits_mat = torch.stack([
                last_logits.get(i, zero_row) for i in range(self.batch_slots)
            ])
            mask = np.zeros((self.batch_slots,), bool)
            mask[list(last_logits)] = True
            toks = self._sample(logits_mat, mask)
        if self.sharing:
            for i, req, seq, _, _ in entries:
                if self.slots[i] is req:
                    self.allocator.register_prefix(i, seq)
        for i, req, _, resumed, _ in entries:
            if not resumed and self.slots[i] is req:
                self._commit_token(i, req, int(toks[i]))
            if self.slots[i] is req:
                req.state = "decode"

    def _prefill_tick(self):
        """Hybrid scheduler: advance every prefill job by one chunk in a
        single dispatch, each slot at its own offset."""
        jobs = sorted(self._prefill_jobs.items())
        if not jobs:
            return
        C = self.prefill_chunk
        t0 = time.perf_counter()
        toks = np.zeros((self.batch_slots, C), np.int32)
        pos = np.full((self.batch_slots, C), self.max_len, np.int32)
        consumed: Dict[int, int] = {}
        for i, job in jobs:
            part = job.seq[job.pos:job.pos + C]
            toks[i, :len(part)] = part
            pos[i, :len(part)] = job.pos + np.arange(len(part))
            consumed[i] = len(part)
        logits = self._dispatch_prefill(toks, pos)
        finished = []
        last_logits = {}
        for i, job in jobs:
            lo, job.pos = job.pos, job.pos + consumed[i]
            self.metrics.prefill_tokens += consumed[i]
            if job.pos >= len(job.seq):
                finished.append((i, job.req, job.seq, job.resumed, job.skip))
                if not job.resumed:
                    last_logits[i] = logits[i, len(job.seq) - 1 - lo]
        synchronize(self.device)
        self.metrics.prefill_time += time.perf_counter() - t0
        for i, *_ in finished:
            job = self._prefill_jobs.pop(i)
            self._lengths[i] = len(job.seq)
        if finished:
            self._complete_prefill(finished, last_logits)

    # --- slots ---------------------------------------------------------
    def _release_slot(self, i: int):
        self._prefill_jobs.pop(i, None)
        self.slots[i] = None
        self._temps[i] = 0.0
        self._lengths[i] = 0
        self._slot_order[i] = None
        self.allocator.free_slot(i)

    def _preempt_victim(self) -> Optional[int]:
        """Lowest priority class first, ties broken youngest."""
        return max(
            (j for j in range(self.batch_slots) if self.slots[j] is not None),
            key=lambda j: (-self.slots[j].priority, self._slot_order[j]),
            default=None,
        )

    def _preempt(self, victim: int):
        req = self.slots[victim]
        self._release_slot(victim)
        req.state = "preempted"
        self.pending.requeue_front(req)
        self.metrics.preemptions += 1

    def _ensure_decode_capacity(self, live: List[int]) -> List[int]:
        """Every live slot must exclusively own the page its next row
        lands in (copy-on-write for shared/registered pages); on pool
        exhaustion preempt the youngest and retry."""
        fresh: List[int] = []
        for i in live:
            while self.slots[i] is not None:
                got = self.allocator.ensure_capacity(
                    i, int(self._lengths[i]) + 1
                )
                if got is not None:
                    fresh += got
                if got is not None and self.sharing:
                    blk = int(self._lengths[i]) // self.layout.page_size
                    if not self.allocator.writable(i, blk):
                        pair = self.allocator.cow(i, blk)
                        if pair is None:
                            got = None
                        else:
                            self.model.clone_pages(
                                self.cache, [pair[0]], [pair[1]]
                            )
                            self.metrics.cow_clones += 1
                if got is not None:
                    break
                self._preempt(self._preempt_victim())
        if fresh:
            self._reset_pages(fresh)
        return [i for i in live if self.slots[i] is not None]

    def _commit_token(self, i: int, req: Request, tok: int):
        now = time.perf_counter()
        if not req.tokens_out:
            req._t_first = now
        elif req._t_last is not None:
            req._itl.append(now - req._t_last)
        req._t_last = now
        req.tokens_out.append(tok)
        req._next_input = tok
        # m generated tokens write prompt + m - 1 rows
        limit = min(req.max_new_tokens, self.max_len - len(req.prompt) + 1)
        if tok == self.eos or len(req.tokens_out) >= limit:
            req.done = True
            req.state = "done"
            self.completed.append(req)
            self._release_slot(i)
            self.metrics.record_request(req)

    # --- tick ----------------------------------------------------------
    def tick(self):
        """Admit, advance prefill by at most one chunk wave (hybrid),
        then decode one token for every decode-state slot."""
        self._admit()
        if self._hybrid and self._prefill_jobs:
            self._prefill_tick()
        live = [
            i for i, r in enumerate(self.slots)
            if r is not None and (not self._hybrid or r.state == "decode")
        ]
        if live:
            live = self._ensure_decode_capacity(live)
            self.metrics.peak_pages_in_use = self.allocator.peak_pages_in_use
        if not live:
            self.metrics.ticks += 1
            return
        t0 = time.perf_counter()
        tokens = np.full((self.batch_slots, 1), self.eos, np.int32)
        active = np.zeros((self.batch_slots,), bool)
        for i in live:
            tokens[i, 0] = self.slots[i]._next_input
            active[i] = True
        inputs = {
            "tokens": self._tensor(tokens),
            "active": self._tensor(active, torch.bool),
            "block_table": self.allocator.table_device(self.device),
        }
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, inputs, self._cache_index()
        )
        self._lengths += active
        if self.sharing:
            # an append that filled a page freezes it: register its content
            bk = self.layout.page_size
            for i in live:
                n = int(self._lengths[i])
                if n and n % bk == 0:
                    req = self.slots[i]
                    self.allocator.register_prefix(
                        i, req.prompt + req.tokens_out
                    )
        next_tokens = self._sample(logits[:, -1, :], active)
        self.metrics.decode_dispatches += 1
        self.metrics.decode_time += time.perf_counter() - t0
        for i in live:
            self.metrics.decode_tokens += 1
            self._commit_token(i, self.slots[i], int(next_tokens[i]))
        self.metrics.ticks += 1

    # --- draining ------------------------------------------------------
    def _has_work(self) -> bool:
        return bool(self.pending) or any(s is not None for s in self.slots)

    def _progress_marker(self) -> Tuple[int, ...]:
        m = self.metrics
        return (m.prefill_tokens, m.decode_tokens, m.preemptions,
                len(self.completed), len(self.pending))

    def run_until_drained(self, max_ticks: int = 100_000) -> List[Request]:
        """Tick until every request completes; a zero-progress tick with
        work queued raises :class:`EngineStalled` (the engine is
        deterministic, so it would repeat forever)."""
        for _ in range(max_ticks):
            if not self._has_work():
                return self.completed
            before = self._progress_marker()
            self.tick()
            if self._progress_marker() == before:
                stuck = sorted([r.uid for r in self.pending]
                               + [r.uid for r in self.slots if r is not None])
                raise EngineStalled(
                    f"zero progress with work queued; stuck uids: {stuck}",
                    stuck,
                )
        if self._has_work():
            raise EngineStalled(
                f"max_ticks={max_ticks} exhausted with work queued", []
            )
        return self.completed

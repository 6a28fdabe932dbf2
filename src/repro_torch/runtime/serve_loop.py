"""Serving runtime (port of ``repro.runtime.serve_loop``): a
continuous-batching chunked-prefill → sparse-decode engine over the
shared page pool (default) or the contiguous per-slot cache
(``paged=False``).

* **Paged pool**: a request is admitted the moment enough pages are free
  for its prompt; decode grows a slot one page at a time; on exhaustion
  the youngest live slot is preempted (pages freed, request requeued at
  the front). Allocation is host-side and deterministic.
* **Restore**: a re-admitted request gets back every row it wrote as it
  was written — its prompt rows by prefill chunks on the original grid
  (or attached pages), the rows its decode steps wrote by replaying
  those steps in later decode ticks (state ``replay``), since prefill
  attention selects other key blocks than decode and would change them.
  (The reference re-prefills the generated rows too.)
* **Contiguous cache**: every slot owns ``max_len`` rows; admission
  zeroes the admitted slots' rows and planes, and a decode tick steps
  idle and mid-prefill slots at the ``max_len`` sentinel, which writes
  nothing. Paged and contiguous engines give the same streams.
* **Prefix sharing**: admission attaches the longest cached prefix from
  the allocator's trie by block-table aliasing; writes into shared or
  registered pages go through copy-on-write; skipped prefill stays on
  the ``prefill_chunk`` grid so sharing never changes a stream.
* **Hybrid tick** (default): each tick dispatches at most one prefill
  chunk covering every mid-prefill slot, then the decode step over
  decode-state slots. ``scheduler="sync"`` runs a whole admission wave
  inline. Both give the same per-uid streams.
* **Sampling**: greedy, or temperature sampling from the reference's
  per-request ``jax.random`` stream (:mod:`repro_torch.core.prng`): a
  slot's key at admission is ``split``ⁿ``(fold_in(PRNGKey(seed),
  uid))[0]``, n the tokens the request has sampled, and each sample
  splits it (``[0]`` kept, ``[1]`` drawn by ``categorical``). A stream
  depends on ``(seed, uid, tokens sampled so far)`` alone — not on
  batch neighbours or preemption, which is what makes hybrid ≡ sync and
  preempted ≡ ample-pool hold — and equals the reference's.
* **Metrics**: prefill and decode tok/s, queue wait, TTFT and
  inter-token latency percentiles — raw (``itl``) and decode-attributed
  (``itl_decode``: the gap less the engine's prefill time between the
  two commits) —, preemptions, page watermark, prefix-cache counters and
  the lifecycle counters. Committed tokens surface at once through
  ``Request.on_token``.
* **Compiled steps**: on CUDA the decode step and the prefill wave
  replay CUDA graphs (:class:`GraphedStep`, which :func:`make_serve_step`
  / :func:`make_prefill_step` make: the reference's jitted steps), one
  dispatch each, bit-identical to the eager steps; ``cuda_graphs=False``
  runs the eager ones, the handle for holding the two against each
  other. Sampling, allocation, prefix registration and copy-on-write
  clones stay on the host, between them.
* **Request lifecycle and fault containment**: requests move pending →
  prefill → decode → {done, cancelled, expired, failed, shed};
  ``cancel(uid)`` and per-request deadlines evict a request at any
  state, freeing its pages under the allocator's rules; ``queue_limit``
  bounds the admission queue (:class:`QueueFull`, optional
  lowest-priority / youngest-first shedding); ``run_until_drained``
  raises :class:`EngineStalled` after ``stall_patience`` zero-progress
  ticks. Non-finite logits quarantine only the faulted slot (terminal
  ``failed``), and step dispatches retry transient errors under a
  ``RetryPolicy``. A seeded :class:`FaultInjector` threads chaos through
  every fault site, and every surviving request streams bit-identically
  to the fault-free run.
* **Observability** (``observability=``): an event trace, a metrics
  registry that the counters mirror into, per-tick series, and — with
  ``device_telemetry`` — the steps' per-layer selection counts, from
  separate ``telemetry=True`` steps whose stats ride the tick's one
  device-to-host copy. An engine built without an injector, a retry
  policy or observability dispatches exactly the steps it did before.
* **Tensor parallelism** (``mesh=``, a ``(1, M)``
  :class:`~repro_torch.launch.mesh.Mesh`): the page pools split by KV
  head over the model axis (:mod:`repro_torch.distributed.sharding`),
  the params stay whole on the mesh's first device, and each dispatch
  runs with the mesh active, so the fused paged ops run once per shard
  and concatenate the heads: a dense model's streams are the
  single-device engine's, bit for bit. An MoE model's experts split over
  the model axis too, where it divides them, and its layers run the
  reference's expert-parallel path (``models/moe.py::apply_moe_sharded``,
  whose cross-shard sum rounds once to the model dtype: its streams are
  the reference's mesh engine's, not the single-device one's). N engines
  behind one queue, one per mesh row, are
  :class:`~repro_torch.runtime.replicated_serve.ReplicatedServeLoop`.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.energon_attention import serving_faults
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import indexed_device
from repro_torch.observability import Observability
from repro_torch.observability.metrics import (
    DEFAULT_LATENCY_BOUNDS,
    MetricsRegistry,
)
from repro_torch.runtime.cuda_graph import GraphedStep
from repro_torch.runtime.fault_tolerance import (
    FaultInjector,
    RetryPolicy,
    StragglerMonitor,
    TransientStepError,
    retry_step,
)
from repro_torch.runtime.paged_cache import PageAllocator, PagedLayout
from repro_torch.runtime.pending import PendingQueue


class QueueFull(RuntimeError):
    """The bounded admission queue rejected a submission (backpressure):
    the queue is at ``queue_limit`` and load shedding either is disabled
    or found no lower-priority victim to drop."""


class EngineStalled(RuntimeError):
    """The engine made zero progress with work still queued — no token
    committed, no request admitted or reaching a terminal state — and
    would otherwise spin to ``max_ticks``; ``uids`` names the stuck
    requests (queued and live)."""

    def __init__(self, msg: str, uids: List[int]):
        super().__init__(msg)
        self.uids = list(uids)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    #: admission and load-shedding rank: higher admits first and
    #: survives shedding; ties shed youngest first
    priority: int = 0
    #: fairness domain: tenants of one priority class take turns
    tenant: str = ""
    #: TTL in seconds from submission; the engine evicts the request at
    #: any state once it expires (None = no deadline)
    deadline_s: Optional[float] = None
    #: streaming hook, called as ``on_token(req, tok)`` the moment each
    #: token commits (first token included), on the engine's tick path:
    #: it must be cheap and must not raise
    on_token: Optional[Callable[["Request", int], None]] = None
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: pending → prefill → decode (→ preempted → prefill → replay …)
    #: → {done, cancelled, expired, failed, shed}
    state: str = "new"
    #: diagnostic of a terminal failure (e.g. "non-finite logits")
    error: Optional[str] = None
    _next_input: int = 0
    _submit_seq: int = -1
    # latency stamps (perf_counter); the gaps keep a bounded tail, the
    # full series streams into the registry's histograms
    _t_submit: Optional[float] = None
    _t_admit: Optional[float] = None
    _t_first: Optional[float] = None
    _t_last: Optional[float] = None
    _itl: "deque[float]" = dataclasses.field(
        default_factory=lambda: deque(maxlen=512)
    )
    #: decode-attributed gaps: the wall gap less the engine's prefill
    #: time between the two commits
    _itl_decode: "deque[float]" = dataclasses.field(
        default_factory=lambda: deque(maxlen=512)
    )
    #: the engine's prefill time at this request's last commit
    _pf_mark: float = 0.0


def _pct(vals: List[float], p: float) -> float:
    return float(np.percentile(np.asarray(vals), p)) if vals else 0.0


class _CounterAttr:
    """Integer engine counter with plain attribute semantics that
    mirrors every write into the engine's optional
    :class:`MetricsRegistry` (a live view, never a stale copy)."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._counters.get(self.name, 0)

    def __set__(self, obj, value):
        obj._counters[self.name] = int(value)
        if obj.registry is not None:
            obj.registry.counter(obj._ns + self.name).value = int(value)


class _GaugeAttr(_CounterAttr):
    """Like :class:`_CounterAttr`, mirrored into a registry gauge (which
    tracks its own peak)."""

    def __set__(self, obj, value):
        obj._counters[self.name] = int(value)
        if obj.registry is not None:
            obj.registry.gauge(obj._ns + self.name).set(int(value))


class EngineMetrics:
    """Prefill and decode throughput measured separately, per-request
    latency records, the paged scheduler's counters and the lifecycle
    counters. Counters are attributes over an optional
    :class:`MetricsRegistry` (``registry=None``: plain ints); the raw
    records are capped at ``max_request_records``, the registry's
    histograms see every observation. ``replica`` namespaces every
    registry name as ``replica{r}/serve_*``, so replicas can share one
    registry or merge into one without summing their gauges.
    ``graph_mode`` says how the engine ran its steps (``graphed``,
    ``eager``, or eager because its mesh spans several cards)."""

    prefill_tokens = _CounterAttr()
    decode_tokens = _CounterAttr()
    prefill_dispatches = _CounterAttr()
    decode_dispatches = _CounterAttr()
    ticks = _CounterAttr()
    preemptions = _CounterAttr()
    peak_pages_in_use = _GaugeAttr()
    prefix_lookups = _CounterAttr()
    prefix_hits = _CounterAttr()
    pages_shared = _CounterAttr()
    prefill_tokens_skipped = _CounterAttr()
    cow_clones = _CounterAttr()
    retries = _CounterAttr()
    stragglers = _CounterAttr()
    failed_requests = _CounterAttr()
    cancelled_requests = _CounterAttr()
    expired_requests = _CounterAttr()
    shed_requests = _CounterAttr()

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 max_request_records: int = 1024,
                 replica: Optional[int] = None):
        self.replica = replica
        self._ns = "serve_" if replica is None else f"replica{replica}/serve_"
        self.registry = registry
        self.graph_mode = "eager"
        self._counters: Dict[str, int] = {}
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

    def _hist(self, name: str):
        return self.registry.histogram(self._ns + name,
                                       DEFAULT_LATENCY_BOUNDS)

    def observe_itl(self, dt: float,
                    decode_dt: Optional[float] = None) -> None:
        """Stream one inter-token gap into the registry's histograms:
        ``dt`` the wall gap, ``decode_dt`` the same gap less the prefill
        time between the two commits."""
        if self.registry is not None:
            self._hist("itl_seconds").observe(dt)
            if decode_dt is not None:
                self._hist("itl_decode_seconds").observe(decode_dt)

    def sync_registry(self) -> None:
        """Push the float time accumulators into the registry (the
        integer counters mirror on every write)."""
        if self.registry is None:
            return
        self.registry.gauge(self._ns + "prefill_time_seconds").set(
            self.prefill_time)
        self.registry.gauge(self._ns + "decode_time_seconds").set(
            self.decode_time)

    def record_request(self, req: Request) -> None:
        """Fold a completed request's latency stamps into the records
        (bounded) and the registry's histograms (streaming)."""
        if req._t_submit is None:
            return
        qw = (req._t_admit - req._t_submit) if req._t_admit is not None else 0.0
        ttft = (req._t_first - req._t_submit) if req._t_first is not None else 0.0
        self.request_records.append({
            "uid": req.uid, "queue_wait": qw, "ttft": ttft,
            "itl": list(req._itl), "itl_decode": list(req._itl_decode),
        })
        self.requests_recorded += 1
        if self.registry is not None:
            self._hist("queue_wait_seconds").observe(qw)
            self._hist("ttft_seconds").observe(ttft)

    def latency_stats(self) -> Dict[str, float]:
        """p50/p95 of queue wait, TTFT and inter-token latency, raw and
        decode-attributed (s; zeros when nothing is recorded)."""
        qw = [r["queue_wait"] for r in self.request_records]
        tt = [r["ttft"] for r in self.request_records]
        itl = [x for r in self.request_records for x in r["itl"]]
        itl_d = [x for r in self.request_records for x in r["itl_decode"]]
        return {
            "requests": float(self.requests_recorded),
            "queue_wait_p50": _pct(qw, 50), "queue_wait_p95": _pct(qw, 95),
            "ttft_p50": _pct(tt, 50), "ttft_p95": _pct(tt, 95),
            "itl_p50": _pct(itl, 50), "itl_p95": _pct(itl, 95),
            "itl_decode_p50": _pct(itl_d, 50),
            "itl_decode_p95": _pct(itl_d, 95),
        }

    def summary(self) -> str:
        s = (
            f"prefill {self.prefill_tokens} tok / "
            f"{self.prefill_dispatches} calls "
            f"({self.prefill_tokens_per_sec:.1f} tok/s) | "
            f"decode {self.decode_tokens} tok / "
            f"{self.decode_dispatches} calls "
            f"({self.decode_tokens_per_sec:.1f} tok/s) | "
            f"{self.ticks} ticks"
        )
        if self.request_records:
            st = self.latency_stats()
            s += (
                f" | queue p50/p95 {st['queue_wait_p50'] * 1e3:.1f}/"
                f"{st['queue_wait_p95'] * 1e3:.1f} ms"
                f" | ttft p50/p95 {st['ttft_p50'] * 1e3:.1f}/"
                f"{st['ttft_p95'] * 1e3:.1f} ms"
                f" | itl p50/p95 {st['itl_p50'] * 1e3:.1f}/"
                f"{st['itl_p95'] * 1e3:.1f} ms"
            )
        if self.peak_pages_in_use:
            s += (
                f" | {self.preemptions} preemptions, "
                f"peak {self.peak_pages_in_use} pages"
            )
        if self.prefix_lookups:
            s += (
                f" | prefix hit-rate {self.prefix_hit_rate:.2f} "
                f"({self.pages_shared} pages shared, "
                f"{self.prefill_tokens_skipped} prefill tok skipped, "
                f"{self.cow_clones} CoW clones)"
            )
        evicted = (self.failed_requests + self.cancelled_requests
                   + self.expired_requests + self.shed_requests)
        if evicted or self.retries or self.stragglers:
            s += (
                f" | lifecycle: {self.retries} retries, "
                f"{self.stragglers} stragglers, "
                f"{self.failed_requests} failed, "
                f"{self.cancelled_requests} cancelled, "
                f"{self.expired_requests} expired, "
                f"{self.shed_requests} shed"
            )
        return s


def make_serve_step(model, *, device: DeviceLike = None, mesh=None):
    """The one-token decode step as one dispatch: the port of the
    reference's ``make_serve_step`` (a jitted ``decode_step`` that
    donates the cache). On CUDA a :class:`GraphedStep` that captures
    ``model.decode_step`` per input signature on first use and replays
    it, updating the cache in place; on the CPU, where graphs do not
    exist, ``model.decode_step`` itself. With ``mesh`` the step runs on
    the mesh's first device with the mesh active (a head-sharded cache's
    fused ops run per shard), graphed where every shard shares that
    card."""
    return _make_step(model, "decode_step", device, mesh)


def make_prefill_step(model, *, device: DeviceLike = None, mesh=None):
    """The chunked-prefill wave as one dispatch (the reference's
    ``make_prefill_step``), as :func:`make_serve_step` is for decode."""
    return _make_step(model, "prefill", device, mesh)


def _make_step(model, method: str, device: DeviceLike, mesh):
    dev = resolve_device(device) if mesh is None else mesh.first_device
    graphed = dev.type == "cuda" and (
        mesh is None or len(mesh.physical_devices) == 1)
    step = GraphedStep(model, method, dev) if graphed else getattr(
        model, method)
    if mesh is None:
        return step

    def on_mesh(*args, **kwargs):
        with shd.active_mesh(mesh):
            return step(*args, **kwargs)

    return on_mesh


def _on_device(tree, device: torch.device):
    """A parameter tree's tensors on ``device`` (the same tensors where
    they live there)."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _poison_logits(logits: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """Chaos hook: ``mask`` slots' logits replaced with NaN (``logits
    [B, V]``, ``mask`` bool ``[B]``), off the step, on its output; a
    fault-free tick never dispatches it."""
    keep = torch.as_tensor(mask, device=logits.device)[:, None]
    return torch.where(keep, torch.nan, logits)


def _take_rows(logits: torch.Tensor, picks: List[Tuple[int, int]]):
    """Copies of ``logits[i, j]`` for each (slot i, row j) of ``picks``,
    keyed by slot: a replayed step's logits are overwritten by the next
    replay, and a wave keeps its slots' last rows across dispatches."""
    if not picks:
        return {}
    rows = torch.stack([logits[i, j] for i, j in picks])
    return {i: rows[k] for k, (i, _) in enumerate(picks)}


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
    the paged KV cache (the default where the model supports it) or the
    contiguous one, on ``device`` (``cuda`` unless given). ``cuda_graphs``
    (default: on where the device is CUDA) replays the decode step and
    the prefill wave from CUDA graphs; False runs them eagerly.

    Lifecycle and faults: ``queue_limit`` bounds the queue (``submit``
    raises :class:`QueueFull`, or with ``load_shedding`` sheds a
    lower-priority queued request); ``default_deadline_s`` is the TTL of
    requests that set none; ``fault_injector`` threads a seeded chaos
    schedule through every fault site and ``retry_policy`` retries a
    failed dispatch (default, with an injector: 3 retries, no backoff);
    ``audit`` checks the allocator's invariants every tick;
    ``stall_patience`` zero-progress ticks raise :class:`EngineStalled`
    (default 1, 32 with an injector). ``observability`` records the event
    trace, the metrics registry and, with its ``device_telemetry``, the
    steps' selection counts.

    Tensor parallelism: ``mesh``, a ``(1, M)``
    :class:`~repro_torch.launch.mesh.Mesh`, splits the page pools by KV
    head over its model axis and runs the engine on its first device
    (``device`` may only name that one); ``replica_id`` namespaces the
    metrics (``replica{r}/serve_*``). A mesh whose shards share one card
    replays graphs like a single-device engine; one over several cards
    runs its steps eagerly (``graph_mode``)."""

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
        paged: Optional[bool] = None,
        num_pages: Optional[int] = None,
        prefix_sharing: Optional[bool] = None,
        queue_limit: Optional[int] = None,
        load_shedding: bool = False,
        default_deadline_s: Optional[float] = None,
        fault_injector: Optional[FaultInjector] = None,
        retry_policy: Optional[RetryPolicy] = None,
        audit: bool = False,
        stall_patience: Optional[int] = None,
        observability: Optional[Observability] = None,
        device: DeviceLike = None,
        cuda_graphs: Optional[bool] = None,
        mesh=None,
        replica_id: Optional[int] = None,
    ):
        self.mesh = mesh
        self.replica_id = replica_id
        self.device = resolve_device(device)
        cards = 1
        if mesh is not None:
            primary = mesh.first_device
            if device is not None and indexed_device(self.device) != primary:
                raise ValueError(f"a mesh engine runs on its mesh's first "
                                 f"device {primary}, not {self.device}")
            self.device = primary
            cards = len(mesh.physical_devices)
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda" and cards == 1
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs needs a CUDA device, not "
                             f"{self.device}")
        if cuda_graphs and cards > 1:
            raise ValueError(
                f"one CUDA graph captures one device's stream: a mesh over "
                f"{cards} cards runs its steps eagerly (cuda_graphs=False)")
        self.cuda_graphs = bool(cuda_graphs)
        self.graph_mode = ("graphed" if self.cuda_graphs else
                           f"eager (the mesh spans {cards} cards)"
                           if cards > 1 and self.device.type == "cuda"
                           else "eager")
        # a mesh engine's params live on its mesh's first device (for a
        # replica on another card than the model's, a copy of them)
        same = (model.device.type == self.device.type if mesh is not None
                else model.device == self.device)
        if not same:
            raise ValueError(
                f"model lives on {model.device}, engine on {self.device}"
            )
        self.paged = model.supports_paged if paged is None else bool(paged)
        if self.paged and not model.supports_paged:
            raise ValueError(
                "paged serving needs an attention family with "
                "decode_key_block > 0 and a non-dense impl"
            )
        if mesh is not None and not self.paged:
            # the recurrent families' caches, and the contiguous one
            raise ValueError("mesh serving requires the paged cache")
        # prefix sharing aliases pages through block tables: paged only
        if prefix_sharing is None:
            prefix_sharing = self.paged
        if prefix_sharing and not self.paged:
            raise ValueError("prefix_sharing requires the paged cache")
        self.model = model
        self.params = params
        # Observability is additive: without device telemetry the engine
        # dispatches exactly the steps it always did; with it, the
        # telemetry variants *instead* (graphed steps of their own on
        # CUDA — only the variant dispatched is ever captured)
        self.obs = observability
        self._telemetry = (observability is not None
                           and observability.device_telemetry)
        # graphed steps (None: the model's eager methods, looked up at
        # each call), sharing one graph memory pool: they replay one at a
        # time, and each consumes or copies its outputs before the next
        self._prefill = self._decode = None
        if self.cuda_graphs:
            pool = torch.cuda.graph_pool_handle()
            if model.supports_prefill:
                self._prefill = GraphedStep(model, "prefill", self.device,
                                            pool, telemetry=self._telemetry)
            self._decode = GraphedStep(model, "decode_step", self.device,
                                       pool, telemetry=self._telemetry)
        self.batch_slots = batch_slots
        self.sharing = bool(prefix_sharing)
        bk = model.cfg.energon.decode_key_block
        # whole decode key blocks (and, paged, at least two pages): the
        # sentinels and limits below must use the rounded row count
        rows = model.decode_cache_len(max_len)
        if self.paged:
            rows = max(-(-rows // bk), 2) * bk
        self.max_len = rows
        self.eos = eos_token
        self.seed = seed
        #: the reference's ``rng=PRNGKey(seed)``
        self._base_key = prng.prng_key(seed)
        self.prefill_chunk = max(1, min(prefill_chunk, max_len))
        cfg = model.cfg
        # per (slot, KV head) row, so a head shard's launches (B·KV/M
        # rows) take what the whole pool's do; a model without chunked
        # prefill admits one token a step
        faults = serving_faults(
            cfg.energon, group=cfg.num_heads // cfg.num_kv_heads,
            cache_len=rows, paged=self.paged,
            chunk=self.prefill_chunk if model.supports_prefill else 1,
            head_dim=cfg.head_dim, dtype=model.dtype,
            cuda_kernels=self.device.type == "cuda",
            windows=model.layer_windows(),
        )
        if faults:
            layout = "paged" if self.paged else "contiguous"
            raise ValueError(
                f"max_len {max_len} / prefill_chunk {prefill_chunk} would "
                f"leave the {layout} serving path: " + "; ".join(faults)
            )
        if scheduler not in ("hybrid", "sync"):
            raise ValueError(
                f"scheduler must be 'hybrid' or 'sync', got {scheduler!r}"
            )
        self.scheduler = scheduler
        self._hybrid = scheduler == "hybrid"
        self.admission_lookahead = max(0, int(admission_lookahead))
        #: slot → in-flight hybrid prefill job
        self._prefill_jobs: Dict[int, _PrefillJob] = {}
        self.layout = self.allocator = None
        if self.paged:
            mb = rows // bk
            if num_pages is None:
                num_pages = batch_slots * mb
            self.layout = PagedLayout(
                num_pages=num_pages, page_size=bk, max_blocks=mb,
                batch_slots=batch_slots,
            )
            self.allocator = PageAllocator(self.layout)
            self.cache = model.init_paged_cache(num_pages,
                                                max_len=self.max_len)
        else:
            self.cache = model.init_cache(batch_slots, self.max_len)
        if mesh is not None:
            self._install_mesh(mesh)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self._temps = np.zeros((batch_slots,), np.float32)
        #: each slot's sampling key (two uint32 words)
        self._keys = np.zeros((batch_slots, 2), np.int64)
        self._lengths = np.zeros((batch_slots,), np.int64)
        self._slot_order: List[Optional[int]] = [None] * batch_slots
        self._admit_seq = itertools.count()
        self._submit_seq = itertools.count()
        self.pending = PendingQueue()
        self.completed: List[Request] = []
        self.metrics = EngineMetrics(
            registry=observability.registry if observability else None,
            replica=replica_id)
        self.metrics.graph_mode = self.graph_mode
        # --- lifecycle / fault tolerance ---------------------------------
        #: queued requests past which `submit` pushes back (preemption
        #: requeues bypass it: evicting a live slot must never fail)
        self.queue_limit = queue_limit
        self.load_shedding = bool(load_shedding)
        self.default_deadline_s = default_deadline_s
        self._injector = fault_injector
        self.retry_policy = retry_policy
        #: per-tick allocator self-check (O(pool) host work a tick)
        self.audit = bool(audit)
        #: consecutive zero-progress ticks tolerated: fault-free one is
        #: permanent (the allocator re-decides identically); under
        #: injection a denied allocation recovers on a later tick
        self.stall_patience = (
            stall_patience if stall_patience is not None
            else (1 if fault_injector is None else 32)
        )
        #: requests that reached a terminal state other than `done`
        self.terminated: List[Request] = []
        self.straggler = StragglerMonitor()
        if observability is not None:
            if self.allocator is not None:
                self.allocator.tracer = observability.trace
            if fault_injector is not None:
                fault_injector.tracer = observability.trace

    def _install_mesh(self, mesh) -> None:
        """Lay the engine out on a tensor-parallel mesh (the reference's
        ``_install_mesh``): the params whole on the mesh's first device
        — splitting the weights would split the output projection's
        contraction into a cross-device sum and change its bits —, but
        an MoE block's experts split over the model axis where it
        divides them (``shard_experts``: views on a one-card mesh), as
        the reference's expert-parallel layer slices them; the page
        pools split by KV head over the model axis (whole on the first
        device where the heads do not divide it). Only the
        paged cache takes a mesh, and only a TP one: the data axis is
        the replica axis, one engine per row."""
        if not self.paged:
            raise ValueError("mesh serving requires the paged cache")
        if shd.dp_size(mesh) > 1:
            raise ValueError(
                "ServeLoop takes a TP-only mesh (data axis == 1); use "
                "ReplicatedServeLoop to span the data axis")
        self.params = shd.shard_experts(
            _on_device(self.params, self.device), mesh)
        self.cache = shd.shard_paged_cache(self.cache, mesh,
                                           self.layout.page_size)

    def _emit(self, name: str, **kw):
        """A trace event, iff observability is attached."""
        if self.obs is not None:
            self.obs.trace.emit(name, **kw)

    def _obs_tick_end(self):
        """Per-tick series and the float gauges, at every tick's end."""
        if self.obs is None:
            return
        self.metrics.sync_registry()
        self.obs.record_tick_series(
            self.metrics.ticks,
            pool_occupancy=self.allocator.pages_in_use if self.paged else 0,
            queue_depth=len(self.pending),
            live_slots=sum(s is not None for s in self.slots),
        )

    @property
    def ticks(self) -> int:
        return self.metrics.ticks

    # --- API -----------------------------------------------------------
    def submit(self, req: Request):
        if len(req.prompt) > self.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens does not fit the "
                f"{self.max_len} cache rows"
            )
        if req._t_submit is None:
            req._t_submit = time.perf_counter()
        if req.deadline_s is None:
            req.deadline_s = self.default_deadline_s
        req._submit_seq = next(self._submit_seq)
        req.state = "pending"
        if self.queue_limit is not None and \
                len(self.pending) >= self.queue_limit:
            # backpressure; with shedding the victim is the queued request
            # least deserving its place (lowest priority, youngest). A
            # newcomer that does not outrank it is itself rejected.
            victim = None
            if self.load_shedding and self.pending:
                victim = self.pending.shed_victim()
            if victim is None or victim.priority >= req.priority:
                raise QueueFull(
                    f"admission queue at limit ({self.queue_limit}); "
                    f"request uid={req.uid} rejected"
                )
            self.pending.remove(victim.uid)
            self._finish_terminal(
                victim, "shed", f"load-shed for higher-priority uid={req.uid}"
            )
        self.pending.append(req)

    def cancel(self, uid: int) -> bool:
        """Cancel a request at any state — queued, live (prefilling or
        decoding) or preempted and requeued; its pages free under the
        allocator's rules, so survivors' streams are untouched. False
        when ``uid`` is unknown or already terminal."""
        req = self.pending.remove(uid)
        if req is not None:
            self._finish_terminal(req, "cancelled")
            return True
        for i, req in enumerate(self.slots):
            if req is not None and req.uid == uid:
                self._evict_slot(i, "cancelled")
                return True
        return False

    @property
    def graphs(self) -> List[GraphedStep]:
        """The engine's graphed steps (none when it runs eagerly)."""
        return [s for s in (self._prefill, self._decode) if s is not None]

    def capture_graphs(self) -> None:
        """Capture the prefill and decode graphs for this engine's shapes
        now, with every slot inactive (the cache is left as it was), so
        that no request waits for a capture. A no-op for an eager engine
        or one whose graphs exist."""
        if not self.cuda_graphs:
            return
        batch = self.batch_slots
        table = ({"block_table": self.allocator.table_device(self.device)}
                 if self.paged else {})
        index = self._cache_index()
        chunk = np.zeros((batch, self.prefill_chunk), np.int32)
        with shd.active_mesh(self.mesh):
            if self._prefill is not None:
                self._prefill.prepare(self.params, self.cache, {
                    "tokens": self._tensor(chunk),
                    "positions": self._tensor(chunk), **table}, index)
            self._decode.prepare(self.params, self.cache, {
                "tokens": self._tensor(np.zeros((batch, 1), np.int32)),
                "active": self._tensor(np.zeros((batch,), bool),
                                       torch.bool),
                **table}, index)

    # --- lifecycle internals -------------------------------------------
    def _finish_terminal(self, req: Request, state: str,
                         error: Optional[str] = None,
                         slot: Optional[int] = None):
        """Move a request to a terminal state other than ``done`` (its
        ``done`` stays False: that means completed normally)."""
        req.state = state
        if error is not None:
            req.error = error
        self.terminated.append(req)
        counter = {"failed": "failed_requests",
                   "cancelled": "cancelled_requests",
                   "expired": "expired_requests",
                   "shed": "shed_requests"}[state]
        setattr(self.metrics, counter, getattr(self.metrics, counter) + 1)
        event = {"failed": "quarantine", "cancelled": "cancel",
                 "expired": "expire", "shed": "shed"}[state]
        self._emit(event, slot=slot, uid=req.uid, error=error or "")

    def _evict_slot(self, i: int, state: str, error: Optional[str] = None):
        """Terminal eviction of a live slot (cancel, expiry, quarantine):
        its pages free at once, as on completion."""
        req = self.slots[i]
        self._release_slot(i)
        self._finish_terminal(req, state, error, slot=i)

    def _expire_deadlines(self):
        """Evict every request whose TTL lapsed, at any state: queued ones
        pop off the queue's deadline heap, live slots are scanned."""
        now = time.perf_counter()
        for req in self.pending.pop_expired(now):
            self._finish_terminal(req, "expired", "deadline exceeded")
        for i, req in enumerate(self.slots):
            if (req is not None and req.deadline_s is not None
                    and req._t_submit is not None
                    and now - req._t_submit > req.deadline_s):
                self._evict_slot(i, "expired", "deadline exceeded")

    def _dispatch(self, fn, *args):
        """One step dispatch with the engine's mesh active (restored
        after, so replica engines on other meshes interleave ticks on
        one host)."""
        with shd.active_mesh(self.mesh):
            return self._dispatch_impl(fn, *args)

    def _dispatch_impl(self, fn, *args):
        """One step dispatch under the engine's retry policy. The
        injector's fault site sits before the call, so a retry
        re-dispatches against an unchanged cache; an engine with neither
        an injector nor a policy calls the step directly."""
        if self._injector is None and self.retry_policy is None:
            return fn(*args)
        first = [True]

        def attempt():
            fresh, first[0] = first[0], False
            if self._injector is not None and \
                    self._injector.step_fault(fresh):
                raise TransientStepError("injected step fault")
            return fn(*args)

        def note(attempt_no, exc):
            self.metrics.retries += 1
            self._emit("retry", site="step_dispatch", attempt=attempt_no)

        policy = self.retry_policy or RetryPolicy(base_delay=0.0)
        return retry_step(attempt, policy=policy, on_retry=note)

    def _ensure_capacity_inj(self, slot: int, n_tokens: int):
        """``allocator.ensure_capacity`` behind the injector's allocation
        fault site, consulted only where the call would allocate; a
        denial looks like pool exhaustion (wait at admission, preempt at
        decode)."""
        if (self._injector is not None
                and self.layout.blocks_for(max(n_tokens, 1))
                > int(self.allocator.n_blocks[slot])
                and self._injector.alloc_failure()):
            return None
        return self.allocator.ensure_capacity(slot, n_tokens)

    def _injected_preempt_storm(self):
        """Chaos site: force-preempt the injector's count of victims, by
        the ordinary preemption policy and machinery."""
        live = [i for i in range(self.batch_slots)
                if self.slots[i] is not None]
        for _ in range(self._injector.preempt_storm(len(live))):
            victim = self._preempt_victim()
            if victim is None:
                break
            self._preempt(victim)

    # --- device helpers --------------------------------------------------
    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _cache_index(self) -> torch.Tensor:
        return self._tensor(self._lengths)

    def _reset_pages(self, pages: List[int]):
        self.model.reset_pages(
            self.cache, self.allocator.page_reset_mask(pages, self.device)
        )

    def _step_fn(self, method: str):
        """The step dispatched for ``method``: the graphed step, else the
        model's eager method (its telemetry variant with telemetry on)."""
        graphed = self._prefill if method == "prefill" else self._decode
        if graphed is not None:
            return graphed
        fn = getattr(self.model, method)
        return functools.partial(fn, telemetry=True) if self._telemetry \
            else fn

    def _sample(self, logits: torch.Tensor, mask: np.ndarray,
                stats: Optional[torch.Tensor] = None):
        """Sample one token for each ``mask`` slot from ``logits [B, V]``:
        argmax at temperature ≤ 0, else the reference's ``_sample_wave``
        draw — the slot's key splits, ``[0]`` stays and ``[1]`` draws
        ``categorical(logits / max(temp, 1e-6))`` — vectorised over the
        sampling slots on the logits' device (one upload of their keys,
        temperatures and rows; none when every slot is greedy). Returns
        host ``(tokens, finite, stats)``: ``finite[b]`` is False where
        slot b's logits hold a NaN/Inf (the quarantine signal), and
        ``stats`` (telemetry) rides the same copy."""
        toks = torch.argmax(logits, dim=-1)
        finite = torch.isfinite(logits).all(dim=-1)
        drawing = [i for i in np.nonzero(mask)[0] if self._temps[i] > 0.0]
        if drawing:
            kept, drawn = prng.split_keys(self._keys[drawing])
            self._keys[drawing] = kept
            temps = self._temps[drawing].view(np.int32).astype(np.int64)
            host = np.concatenate(
                [drawn, temps[:, None], np.asarray(drawing)[:, None]], 1)
            packed = torch.from_numpy(host).to(logits.device)
            rows = packed[:, 3]
            t = packed[:, 2].to(torch.int32).view(torch.float32)
            # a non-finite row draws from zeros instead (its slot is
            # quarantined and the token dropped): the draw must not fail
            scaled = torch.where(finite[rows, None],
                                 logits.index_select(0, rows).float(), 0.0)
            scaled = scaled / torch.clamp(t, min=1e-6)[:, None]
            toks = toks.index_copy(0, rows,
                                   prng.categorical(packed[:, :2], scaled))
        parts = [toks.to(torch.int64), finite.to(torch.int64)]
        if stats is not None:
            parts.append(stats.reshape(-1).to(torch.int64))
        out = torch.cat(parts).cpu().numpy()
        b = logits.shape[0]
        host_stats = (out[2 * b:].reshape(stats.shape)
                      if stats is not None else None)
        return out[:b], out[b:2 * b].astype(bool), host_stats

    # --- admission -----------------------------------------------------
    def _plan_prefix_attach(self, seq_tokens: List[int], resumed: bool,
                            chunked_len: int):
        """Longest cached prefix: ``(skip, attach_pages, clone_src)``.
        Recomputed chunks stay on the ``prefill_chunk`` grid (prefill
        selection pools per query block); a fresh request keeps its last
        token to seed sampling; a resumed one restores what it wrote past
        the match by prefill chunks only below ``chunked_len`` (the rows
        its first admission prefilled), so its skip leaves the grid there
        (the rest replays, or aliasing covered everything)."""
        matched = self.allocator.match_prefix(seq_tokens)
        if not matched:
            return 0, [], None
        bk = self.layout.page_size
        if resumed:
            skip = min(len(matched) * bk, len(seq_tokens))
            if skip < chunked_len:
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
        admitted_slots: List[int] = []
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
                    admitted_slots.append(i)
                    admitted = True
                    break
                misses += 1
                if misses > self.admission_lookahead:
                    break
                req = next(cand_iter, None)
            if not admitted:
                break
        if self.paged:
            # slot hygiene per page, at allocation: fresh pages are
            # zeroed; attached and CoW pages carry live data
            if new_pages:
                self._reset_pages(new_pages)
            self.metrics.peak_pages_in_use = self.allocator.peak_pages_in_use
        elif admitted_slots:
            # admitted slots must not inherit their previous occupants'
            # recurrent state or stale K/V rows: one masked pass a wave
            mask = np.zeros((self.batch_slots,), bool)
            mask[admitted_slots] = True
            self.model.reset_decode_slots(self.cache, self._tensor(
                mask, torch.bool))
        if sequential:
            # token by token, synchronously under both schedulers: there
            # is no chunk structure to interleave
            self._sequential_prefill_wave(sequential)
        if chunked:
            if self._hybrid:
                self._enqueue_prefill_jobs(chunked)
            else:
                self._prefill_slots(chunked)

    def _try_admit(self, i: int, req: Request, now: float,
                   new_pages: List[int], chunked: List,
                   sequential: List) -> bool:
        """Admit ``req`` into free slot ``i`` (paged: prefix attach and
        pages first, :meth:`_admit_pages`); False when the pool cannot
        cover it."""
        resumed = bool(req.tokens_out)
        seq_tokens = req.prompt + req.tokens_out[:-1] if resumed else req.prompt
        use_chunked = resumed or (self.model.supports_prefill
                                  and len(req.prompt) > 1)
        skip = 0
        if self.paged:
            skip = self._admit_pages(i, req, seq_tokens, use_chunked,
                                     resumed, new_pages)
            if skip is None:
                return False
        self.pending.remove(req.uid)
        self.pending.note_admitted(req)
        self.slots[i] = req
        req.state = "prefill"
        self._slot_order[i] = next(self._admit_seq)
        self._emit("admit", slot=i, uid=req.uid, resumed=resumed,
                   prompt_len=len(seq_tokens), skip=skip)
        if req._t_admit is None:
            req._t_admit = now
        self._temps[i] = req.temperature
        self._keys[i] = prng.request_key(self._base_key, req.uid,
                                         len(req.tokens_out))
        self._lengths[i] = 0
        if resumed:
            if seq_tokens:
                # restore what it wrote as it was written: the rows its
                # first admission prefilled by chunks on the same grid,
                # the rows decode wrote by replaying those decode steps
                # (tick) — prefill attention selects other blocks, so
                # re-prefilled decode rows would differ
                upto = max(skip, self._chunked_len(req))
                chunked.append((i, req, seq_tokens[:upto], True, skip))
            else:
                req.state = "decode"
        elif use_chunked:
            chunked.append((i, req, seq_tokens, False, skip))
        else:
            sequential.append((i, req))
        return True

    def _admit_pages(self, i: int, req: Request, seq_tokens: List[int],
                     use_chunked: bool, resumed: bool,
                     new_pages: List[int]) -> Optional[int]:
        """Prefix attach then page allocation for slot ``i``, with full
        rollback when the pool cannot cover it (returns None); else the
        number of prompt tokens the attached prefix skips."""
        skip, attach, clone_src = 0, [], None
        if self.sharing and use_chunked and len(seq_tokens) > 1:
            skip, attach, clone_src = self._plan_prefix_attach(
                seq_tokens, resumed, self._chunked_len(req)
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
            pages = self._ensure_capacity_inj(i, max(len(seq_tokens), 1))
        if pages is None:
            self.allocator.free_slot(i)
            return None
        new_pages += pages
        if self.sharing and use_chunked and len(seq_tokens) > 1:
            self.metrics.prefix_lookups += 1
        if pair is not None:
            self.metrics.cow_clones += 1
            self._emit("cow_clone", slot=i, uid=req.uid, src=pair[0],
                       dst=pair[1], site="admit")
        if skip > 0:
            self.metrics.prefix_hits += 1
            self.metrics.pages_shared += len(attach) + (clone_src is not None)
            self.metrics.prefill_tokens_skipped += skip
        return skip

    def _chunked_len(self, req: Request) -> int:
        """Rows a request's first admission wrote by chunked prefill (a
        one-token prompt's row is written by its first decode step; a
        model without chunked prefill writes every row by decode steps,
        so a resumed request replays them all)."""
        return (len(req.prompt)
                if len(req.prompt) > 1 and self.model.supports_prefill
                else 0)

    def _resume(self, i: int, req: Request):
        """A restored slot decodes once its rows reach what it had
        written; until then its state is ``replay``: each decode tick
        feeds it its next written token instead of sampling."""
        written = len(req.prompt) + len(req.tokens_out) - 1
        req.state = "replay" if self._lengths[i] < written else "decode"

    def _replay_input(self, i: int, req: Request) -> int:
        pos = int(self._lengths[i])
        if pos < len(req.prompt):
            return req.prompt[pos]
        return req.tokens_out[pos - len(req.prompt)]

    def _enqueue_prefill_jobs(self, admitted):
        for i, req, seq, resumed, skip in admitted:
            if skip >= len(seq):
                # a resume with nothing to prefill: restored by table
                # aliasing (and replay)
                self._lengths[i] = skip
                if self.sharing:
                    self.allocator.register_prefix(i, seq)
                self._resume(i, req)
            else:
                self._prefill_jobs[i] = _PrefillJob(
                    req=req, seq=seq, resumed=resumed, skip=skip, pos=skip,
                )

    def _dispatch_prefill(self, toks, pos):
        """One prefill dispatch; returns ``(logits, stats or None)``."""
        inputs = {"tokens": self._tensor(toks), "positions": self._tensor(pos)}
        if self.paged:
            inputs["block_table"] = self.allocator.table_device(self.device)
        out = self._dispatch(self._step_fn("prefill"), self.params,
                             self.cache, inputs, self._cache_index())
        self.cache = out[1]
        self.metrics.prefill_dispatches += 1
        return out[0], (out[2] if self._telemetry else None)

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
        stats_chunks = []
        for c in range(n_chunks):
            toks = np.zeros((self.batch_slots, C), np.int32)
            pos = np.full((self.batch_slots, C), self.max_len, np.int32)
            for i, req, seq, _, skip in admitted:
                lo = skip + c * C
                part = seq[lo:lo + C]
                if part:
                    toks[i, :len(part)] = part
                    pos[i, :len(part)] = lo + np.arange(len(part))
            logits, stats = self._dispatch_prefill(toks, pos)
            if stats is not None:
                # a replay overwrites its stats: keep this chunk's
                stats_chunks.append(stats.clone())
            self._emit("prefill_chunk", site="prefill", chunk=c,
                       slots=len(admitted))
            picks = []
            for i, req, seq, resumed, skip in admitted:
                lo = skip + c * C
                if not resumed and lo < len(seq) <= lo + C:
                    picks.append((i, len(seq) - 1 - lo))
            last_logits.update(_take_rows(logits, picks))
        synchronize(self.device)
        for i, req, seq, _, skip in admitted:
            self._lengths[i] = len(seq)
            self.metrics.prefill_tokens += len(seq) - skip
        self.metrics.prefill_time += time.perf_counter() - t0
        self._emit("prefill_wave", site="prefill",
                   dur=time.perf_counter() - t0, chunks=n_chunks,
                   slots=len(admitted))
        if stats_chunks:
            # one copy for the whole wave; the stats are tiny [L, B, 4]
            for st in torch.stack(stats_chunks).cpu().numpy():
                self.obs.record_prefill_stats(st)
        self._complete_prefill(admitted, last_logits)

    def _sequential_prefill_wave(self, admitted):
        """Token-by-token admission for models without chunked prefill
        (the recurrent families) and one-token prompts: every admitted
        slot marches together, token t of each prompt riding one
        whole-batch decode step (the graphed one where graphs are on),
        so a wave costs max(Lᵢ) − 1 dispatches. The ``active`` mask
        advances the recurrent state of exactly the slots that consumed
        a token; on the contiguous cache the other slots step at the
        ``max_len`` sentinel, which writes no K/V row (the reference
        writes a row at a live neighbour's length, which its next token
        overwrites, block planes re-quantized from the float rows)."""
        t0 = time.perf_counter()
        n_steps = max(len(req.prompt) - 1 for _, req in admitted)
        for t in range(n_steps):
            tokens = np.full((self.batch_slots, 1), self.eos, np.int32)
            active = np.zeros((self.batch_slots,), bool)
            for i, req in admitted:
                if t < len(req.prompt) - 1:
                    tokens[i, 0] = req.prompt[t]
                    active[i] = True
            inputs = {"tokens": self._tensor(tokens),
                      "active": self._tensor(active, torch.bool)}
            # only a contiguous cache takes a step here: a paged model
            # admits only one-token prompts this way, which take none
            index = np.where(active, self._lengths, self.max_len)
            out = self._dispatch(self._step_fn("decode_step"), self.params,
                                 self.cache, inputs, self._tensor(index))
            self.cache = out[1]
            self._lengths += active
            self.metrics.prefill_dispatches += 1
            self.metrics.prefill_tokens += int(active.sum())
        if n_steps > 0:
            synchronize(self.device)
            self.metrics.prefill_time += time.perf_counter() - t0
        for i, req in admitted:
            req._next_input = req.prompt[-1] if req.prompt else self.eos
            req.state = "decode"

    def _complete_prefill(self, entries, last_logits):
        """The shared tail of a sync wave and of hybrid job completion,
        in the order the contracts rely on: sample every fresh finishing
        slot's first token (the ``poison_prefill`` chaos site just
        before), quarantine non-finite slots *before* prefix
        registration (a faulted slot's pages never enter the trie),
        register the survivors' prefixes, commit first tokens, flip to
        decode."""
        toks = None
        if last_logits:
            zero_row = torch.zeros_like(next(iter(last_logits.values())))
            logits_mat = torch.stack([
                last_logits.get(i, zero_row) for i in range(self.batch_slots)
            ])
            mask = np.zeros((self.batch_slots,), bool)
            mask[list(last_logits)] = True
            if self._injector is not None:
                doomed = self._injector.poison_prefill([
                    req.uid for _, req, _, resumed, _ in entries
                    if not resumed
                ])
                if doomed:
                    pmask = np.zeros((self.batch_slots,), bool)
                    for i, req, _, resumed, _ in entries:
                        if not resumed and req.uid in doomed:
                            pmask[i] = True
                    logits_mat = _poison_logits(logits_mat, pmask)
            toks, finite, _ = self._sample(logits_mat, mask)
            # idle rows are zero (finite): only real fresh slots trip it
            for i, req, _, resumed, _ in entries:
                if not resumed and not finite[i]:
                    self._evict_slot(i, "failed", "non-finite logits")
        if self.sharing:
            # registration only now: mid-wave, a sharer could have read a
            # page its writer had not finished
            for i, req, seq, _, _ in entries:
                if self.slots[i] is req:
                    self.allocator.register_prefix(i, seq)
        for i, req, _, resumed, _ in entries:
            if self.slots[i] is not req:
                continue
            if resumed:
                self._resume(i, req)
            else:
                self._commit_token(i, req, int(toks[i]))
                if self.slots[i] is req:
                    req.state = "decode"

    def _prefill_tick(self):
        """Hybrid scheduler: advance every prefill job by one chunk in a
        single dispatch, each slot at its own offset; finished jobs run
        the shared completion tail."""
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
        logits, stats = self._dispatch_prefill(toks, pos)
        self._emit("prefill_chunk", site="prefill",
                   chunk=min((j.pos - j.skip) // C for _, j in jobs),
                   slots=len(jobs))
        finished = []
        picks = []
        for i, job in jobs:
            lo, job.pos = job.pos, job.pos + consumed[i]
            # per chunk: keeps the stall detector's progress marker
            # moving on prefill-only ticks
            self.metrics.prefill_tokens += consumed[i]
            if job.pos >= len(job.seq):
                finished.append((i, job.req, job.seq, job.resumed, job.skip))
                if not job.resumed:
                    picks.append((i, len(job.seq) - 1 - lo))
        last_logits = _take_rows(logits, picks)
        # synced before the clock stops: the ITL attribution subtracts
        # prefill time, which must be the device's
        synchronize(self.device)
        self.metrics.prefill_time += time.perf_counter() - t0
        self._emit("prefill_tick", site="prefill",
                   dur=time.perf_counter() - t0, slots=len(jobs),
                   finished=len(finished))
        if stats is not None:
            self.obs.record_prefill_stats(stats.cpu().numpy())
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
        if self.paged:
            self.allocator.free_slot(i)

    def _preempt_victim(self) -> Optional[int]:
        """Lowest priority class first, ties broken youngest; a
        mid-prefill slot is as evictable as a decoding one."""
        return max(
            (j for j in range(self.batch_slots) if self.slots[j] is not None),
            key=lambda j: (-self.slots[j].priority, self._slot_order[j]),
            default=None,
        )

    def _preempt(self, victim: int):
        """Evict a live slot and requeue it at the front (past the queue
        limit); it re-prefills what it wrote on re-admission."""
        req = self.slots[victim]
        self._release_slot(victim)
        req.state = "preempted"
        self.pending.requeue_front(req)
        self.metrics.preemptions += 1
        self._emit("preempt", slot=victim, uid=req.uid,
                   written=max(len(req.prompt) + len(req.tokens_out) - 1, 0))

    def _ensure_decode_capacity(self, live: List[int]) -> List[int]:
        """Every live slot must exclusively own the page its next row
        lands in (copy-on-write for shared/registered pages); on pool
        exhaustion preempt the youngest and retry."""
        fresh: List[int] = []
        for i in live:
            while self.slots[i] is not None:
                got = self._ensure_capacity_inj(i, int(self._lengths[i]) + 1)
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
                            self._emit("cow_clone", slot=i,
                                       uid=self.slots[i].uid, src=pair[0],
                                       dst=pair[1], site="decode")
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
            dt = now - req._t_last
            # tick-phase attribution: the prefill time between this
            # request's commits is scheduler latency, not decode latency
            stall = max(self.metrics.prefill_time - req._pf_mark, 0.0)
            decode_dt = max(dt - stall, 0.0)
            req._itl.append(dt)
            req._itl_decode.append(decode_dt)
            self.metrics.observe_itl(dt, decode_dt)
        req._t_last = now
        req._pf_mark = self.metrics.prefill_time
        req.tokens_out.append(tok)
        req._next_input = tok
        if req.on_token is not None:
            req.on_token(req, tok)
        # m generated tokens write prompt + m - 1 rows
        limit = min(req.max_new_tokens, self.max_len - len(req.prompt) + 1)
        if tok == self.eos or len(req.tokens_out) >= limit:
            req.done = True
            req.state = "done"
            self.completed.append(req)
            self._release_slot(i)
            self.metrics.record_request(req)
            self._emit("finish", slot=i, uid=req.uid,
                       tokens=len(req.tokens_out))

    def _audit_tick(self):
        """Optional per-tick allocator self-check: raises at the tick
        that corrupts its state."""
        if self.audit and self.paged:
            self.allocator.check_invariants()

    def _end_tick(self):
        """Every tick counts once (idle and prefill-only ones too, so the
        per-tick series stay one point a tick), then audit and series."""
        self.metrics.ticks += 1
        self._audit_tick()
        self._obs_tick_end()

    # --- tick ----------------------------------------------------------
    def tick(self):
        """Expire deadlines, admit, advance prefill by at most one chunk
        wave (hybrid), then decode one token for every decode-state slot
        (quarantining any slot whose logits go non-finite); a replaying
        slot rides the same step to restore its next written row."""
        if self.obs is not None:
            self.obs.trace.tick = self.metrics.ticks
        self._expire_deadlines()
        if self._injector is not None:
            self._injected_preempt_storm()
        self._admit()
        if self._hybrid and self._prefill_jobs:
            self._prefill_tick()
        live = [
            i for i, r in enumerate(self.slots)
            if r is not None
            and (not self._hybrid or r.state in ("decode", "replay"))
        ]
        if live and self.paged:
            live = self._ensure_decode_capacity(live)
            self.metrics.peak_pages_in_use = self.allocator.peak_pages_in_use
        if not live:
            self._end_tick()
            return
        t0 = time.perf_counter()
        tokens = np.full((self.batch_slots, 1), self.eos, np.int32)
        active = np.zeros((self.batch_slots,), bool)
        for i in live:
            req = self.slots[i]
            tokens[i, 0] = (self._replay_input(i, req)
                            if req.state == "replay" else req._next_input)
            active[i] = True
        # the slots that sample: a replaying slot's logits are dropped
        sampling = [i for i in live if self.slots[i].state == "decode"]
        mask = np.zeros((self.batch_slots,), bool)
        mask[sampling] = True
        inputs = {
            "tokens": self._tensor(tokens),
            "active": self._tensor(active, torch.bool),
        }
        step_index = self._lengths
        if self.paged:
            inputs["block_table"] = self.allocator.table_device(self.device)
        else:
            # contiguous writes are positional: an idle or mid-prefill
            # slot steps at the max_len sentinel, which writes nothing
            # (its rows from earlier chunks must survive the tick)
            step_index = np.where(active, self._lengths, self.max_len)
        out = self._dispatch(self._step_fn("decode_step"), self.params,
                             self.cache, inputs, self._tensor(step_index))
        logits, self.cache = out[0], out[1]
        self._lengths += active
        if self.sharing:
            # an append that filled a page freezes it: register its content
            bk = self.layout.page_size
            for i in live:
                n = int(self._lengths[i])
                if n and n % bk == 0:
                    req = self.slots[i]
                    self.allocator.register_prefix(
                        i, (req.prompt + req.tokens_out)[:n]
                    )
        logits = logits[:, -1, :]
        if self._injector is not None:
            doomed = self._injector.poison_decode(
                [self.slots[i].uid for i in sampling])
            if doomed:
                pmask = np.zeros((self.batch_slots,), bool)
                for i in sampling:
                    if self.slots[i].uid in doomed:
                        pmask[i] = True
                logits = _poison_logits(logits, pmask)
        next_tokens, finite, stats = self._sample(
            logits, mask, out[2] if self._telemetry else None)
        if stats is not None:
            self.obs.record_decode_stats(stats, slots=live)
        if self._injector is not None:
            # an injected straggler: the sleep lands inside decode time
            delay = self._injector.step_delay()
            if delay:
                time.sleep(delay)
        self.metrics.decode_dispatches += 1
        elapsed = time.perf_counter() - t0
        self.metrics.decode_time += elapsed
        self._emit("decode_tick", site="decode", dur=elapsed, live=len(live))
        if self.straggler.record(elapsed):
            self.metrics.stragglers += 1
        for i in live:
            req = self.slots[i]
            if req.state == "replay":
                self._resume(i, req)
                continue
            if not finite[i]:
                # quarantine: only the faulted slot dies
                self._evict_slot(i, "failed", "non-finite logits")
                continue
            self.metrics.decode_tokens += 1
            self._commit_token(i, req, int(next_tokens[i]))
        self._end_tick()

    # --- draining ------------------------------------------------------
    def _has_work(self) -> bool:
        return bool(self.pending) or any(s is not None for s in self.slots)

    def _progress_marker(self) -> Tuple[int, ...]:
        """Any token computed (a replayed row included: its decode step
        counts), request finished or evicted, or change in queue depth
        counts as progress."""
        m = self.metrics
        return (m.prefill_tokens, m.decode_tokens, m.decode_dispatches,
                m.preemptions, len(self.completed), len(self.terminated),
                len(self.pending))

    def _stuck_uids(self) -> List[int]:
        return sorted([r.uid for r in self.pending]
                      + [r.uid for r in self.slots if r is not None])

    def run_until_drained(self, max_ticks: int = 100_000, *,
                          raise_on_stall: bool = True) -> List[Request]:
        """Tick until every request reaches a terminal state. After
        ``stall_patience`` consecutive zero-progress ticks with work
        queued, or ``max_ticks`` spent with work left,
        :class:`EngineStalled` names the stuck uids
        (``raise_on_stall=False``: return the completed ones instead)."""
        stagnant = 0
        for _ in range(max_ticks):
            if not self._has_work():
                return self.completed
            before = self._progress_marker()
            self.tick()
            if self._progress_marker() != before:
                stagnant = 0
                continue
            stagnant += 1
            if stagnant > self.stall_patience:
                if raise_on_stall:
                    raise EngineStalled(
                        f"zero progress over {stagnant} consecutive ticks "
                        f"with work queued; stuck uids: "
                        f"{self._stuck_uids()}", self._stuck_uids())
                return self.completed
        if self._has_work() and raise_on_stall:
            raise EngineStalled(
                f"max_ticks={max_ticks} exhausted with work queued; stuck "
                f"uids: {self._stuck_uids()}", self._stuck_uids())
        return self.completed

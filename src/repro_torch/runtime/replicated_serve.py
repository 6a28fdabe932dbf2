"""Data-parallel serving (port of ``repro.runtime.replicated_serve``): N
engine replicas over a ``(data, model)`` mesh behind one shared
admission queue.

Each replica is an ordinary :class:`~repro_torch.runtime.serve_loop.
ServeLoop` on one row of the mesh — a ``(1, M)`` submesh, its page pool
split by KV head over the row — with its own allocator, preemption
domain and metrics namespace (``replica{r}/serve_*``). Every replica
shares the one model object and params. The replica dimension is a
placement concern only:

* **Placement is deterministic.** A request's home replica is a stable
  hash of its uid (:func:`replica_home`, the reference's, bit for bit).
  When the home's load (queued + live requests) exceeds the least
  loaded replica's by more than ``spill_threshold``, or its bounded
  queue rejects the request, the request spills to the least loaded
  replica (lowest id on ties). A fixed trace places identically on
  every run.
* **Streams are placement-invariant.** Every replica holds the same
  base key (the reference's ``rng=PRNGKey(seed)``) and draws a
  request's samples from ``fold_in(base, uid)`` split once a sample
  (:mod:`repro_torch.core.prng`), so a request's stream does not depend
  on which replica ran it; with each
  engine's own contracts (preempted ≡ ample, shared ≡ unshared, TP ≡
  single device) it equals the stream of a single-device engine.
* **Metrics merge, not mix.** :meth:`ReplicatedServeLoop.merged_metrics`
  sums the counters; ``peak_pages_in_use`` and the wall-clock
  accumulators take the max over replicas (disjoint pools; replicas
  that tick concurrently on their own devices).
  :meth:`ReplicatedServeLoop.merged_registry` holds the per-replica
  series and the stripped cross-replica aggregates.

One host ticks the replicas in turn. On a mesh whose rows share one
card (a simulated mesh) their dispatches serialize on it; on a mesh
over several cards each replica's steps run on its own row's devices.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.observability.metrics import (
    MetricsRegistry,
    strip_replica_prefix,
)
from repro_torch.runtime.serve_loop import (
    EngineMetrics,
    EngineStalled,
    QueueFull,
    Request,
    ServeLoop,
)


def replica_home(uid: int, n_replicas: int) -> int:
    """Stable uid → replica hash (Knuth multiplicative, high bits: the
    low bits of an odd multiplier mod a small n degenerate to
    ``uid % n``)."""
    return ((uid * 2654435761) >> 13) % n_replicas


def _submesh(mesh, r: int):
    """Row ``r`` of a ``(data, model)`` mesh as a ``(1, model)`` mesh,
    the model axis keeping its name so each replica's fused ops shard
    over it as a lone tensor-parallel engine's do."""
    return mesh.submesh(r)


class ReplicatedServeLoop:
    """N data-parallel :class:`ServeLoop` replicas behind one admission
    queue with deterministic placement.

    ``mesh`` (axes ``('data', 'model')``) pins replica r to mesh row r —
    its params on the row's first device, its page pool split by head
    over the row — or ``replicas=N`` alone gives N single-device engines
    (host-only replication, on ``engine_kw``'s device). Every other
    keyword (``batch_slots``, ``num_pages``, ``queue_limit``, …) applies
    to every replica; ``num_pages`` is per replica (the pools are
    disjoint)."""

    def __init__(
        self,
        model,
        params,
        *,
        mesh=None,
        replicas: Optional[int] = None,
        spill_threshold: Optional[int] = None,
        seed: int = 0,
        **engine_kw,
    ):
        if mesh is not None:
            if "data" not in mesh.axis_names:
                raise ValueError(
                    f"replicated serving needs a 'data' mesh axis, got "
                    f"{mesh.axis_names}")
            n = mesh.shape["data"]
            if replicas is not None and replicas != n:
                raise ValueError(f"replicas={replicas} != mesh data axis {n}")
            replicas = n
        if replicas is None or replicas < 1:
            raise ValueError("need mesh or replicas >= 1")
        self.mesh = mesh
        self.n_replicas = replicas
        # every replica shares the base key: streams fold by uid, so
        # placement cannot perturb them
        self.engines: List[ServeLoop] = [
            ServeLoop(
                model, params, seed=seed,
                mesh=_submesh(mesh, r) if mesh is not None else None,
                replica_id=r, **engine_kw,
            )
            for r in range(replicas)
        ]
        #: load imbalance tolerated before a home placement spills; one
        #: batch of requests by default
        self.spill_threshold = (spill_threshold if spill_threshold is not None
                                else self.engines[0].batch_slots)
        #: uid → the replica that took it (after any spill)
        self.placement: Dict[int, int] = {}

    # --- placement -----------------------------------------------------

    def _load(self, r: int) -> int:
        e = self.engines[r]
        return len(e.pending) + sum(s is not None for s in e.slots)

    def submit(self, req: Request) -> int:
        """Place ``req`` and submit it; returns the replica that took it.

        Home is the uid's hash. The request spills to the least loaded
        replica when the home's load exceeds that one's by more than
        ``spill_threshold``, or when the home's bounded queue rejects
        it; if the least loaded replica rejects it too, :class:`QueueFull`
        propagates (backpressure stays visible)."""
        home = replica_home(req.uid, self.n_replicas)
        loads = [self._load(r) for r in range(self.n_replicas)]
        least = min(range(self.n_replicas), key=lambda r: loads[r])
        target = home
        if loads[home] - loads[least] > self.spill_threshold:
            target = least
        try:
            self.engines[target].submit(req)
        except QueueFull:
            if target == least:
                raise
            self.engines[least].submit(req)
            target = least
        self.placement[req.uid] = target
        return target

    def capture_graphs(self) -> None:
        """Capture every replica's graphs before the first request
        (:meth:`ServeLoop.capture_graphs`)."""
        for e in self.engines:
            e.capture_graphs()

    # --- draining ------------------------------------------------------

    def _has_work(self) -> bool:
        return any(e._has_work() for e in self.engines)

    def tick(self) -> None:
        """One tick of every replica that has work, in turn."""
        for e in self.engines:
            if e._has_work():
                e.tick()

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        """Tick every replica until every request is terminal. Stall
        detection is aggregate: a tick in which no replica progresses is
        stagnant (the replicas must interleave, so each engine's own
        drain loop is not used); past the largest ``stall_patience``,
        :class:`EngineStalled` names the stuck uids."""
        patience = max(e.stall_patience for e in self.engines)
        stagnant = 0
        for _ in range(max_ticks):
            if not self._has_work():
                return self.completed
            before = tuple(e._progress_marker() for e in self.engines)
            self.tick()
            if tuple(e._progress_marker() for e in self.engines) == before:
                stagnant += 1
                if stagnant > patience:
                    raise EngineStalled(
                        f"replicated engine stalled; stuck uids: "
                        f"{self._stuck_uids()}", self._stuck_uids())
            else:
                stagnant = 0
        if self._has_work():
            raise EngineStalled(f"max_ticks={max_ticks} exhausted; stuck "
                                f"uids: {self._stuck_uids()}",
                                self._stuck_uids())
        return self.completed

    def _stuck_uids(self) -> List[int]:
        return sorted(u for e in self.engines for u in e._stuck_uids())

    @property
    def completed(self) -> List[Request]:
        return sorted((r for e in self.engines for r in e.completed),
                      key=lambda r: r.uid)

    @property
    def terminated(self) -> List[Request]:
        return sorted((r for e in self.engines for r in e.terminated),
                      key=lambda r: r.uid)

    # --- observability -------------------------------------------------

    def merged_metrics(self) -> EngineMetrics:
        """Cross-replica :class:`EngineMetrics`: counters sum,
        ``peak_pages_in_use`` is the per-replica max (disjoint pools),
        and the wall-clock accumulators take the max over replicas (the
        parallel-makespan model). Request records concatenate in uid
        order."""
        out = EngineMetrics()
        counters = [n for n, d in vars(EngineMetrics).items()
                    if type(d).__name__ == "_CounterAttr"]
        for e in self.engines:
            m = e.metrics
            for n in counters:
                setattr(out, n, getattr(out, n) + getattr(m, n))
            out.peak_pages_in_use = max(out.peak_pages_in_use,
                                        m.peak_pages_in_use)
            out.prefill_time = max(out.prefill_time, m.prefill_time)
            out.decode_time = max(out.decode_time, m.decode_time)
            out.requests_recorded += m.requests_recorded
        out.graph_mode = self.engines[0].metrics.graph_mode
        for rec in sorted((r for e in self.engines
                           for r in e.metrics.request_records),
                          key=lambda r: r["uid"]):
            out.request_records.append(rec)
        return out

    def merged_registry(self) -> MetricsRegistry:
        """One registry with every replica's ``replica{r}/serve_*`` series
        and the stripped cross-replica ``serve_*`` aggregates (counters
        and histograms summed, gauges max'd). Engines sharing one
        observability registry (the namespaces keep them apart) merge
        once."""
        regs: List[MetricsRegistry] = []
        for e in self.engines:
            e.metrics.sync_registry()
            reg = e.metrics.registry
            if reg is None:
                # an engine without observability: mirror its host-side
                # counters into a registry of its own
                reg = MetricsRegistry()
                m = EngineMetrics(registry=reg, replica=e.replica_id)
                for n, v in e.metrics._counters.items():
                    setattr(m, n, v)
                m.prefill_time = e.metrics.prefill_time
                m.decode_time = e.metrics.decode_time
                m.sync_registry()
            if all(reg is not r for r in regs):
                regs.append(reg)
        out = MetricsRegistry()
        for reg in regs:
            out.merge(reg)
            # the aggregate pass folds only the namespaced series
            out.merge(reg, rename=lambda n: (
                strip_replica_prefix(n) if strip_replica_prefix(n) != n
                else None))
        return out

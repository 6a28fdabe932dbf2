"""Admission queue for the serving engine (a copy of
``repro.runtime.pending``): amortized O(1) operations
plus the admission *policy* order (priority classes, per-tenant
round-robin fairness).

The engine's original queue was a plain list: ``pop(0)`` on every
admission, ``remove()`` on every cancel/shed/expiry — O(n) each, O(n²)
once a load bench queues thousands. :class:`PendingQueue` keeps

* a ``uid → Request`` dict (liveness is one lookup),
* an arrival-order deque and a preempted-requeue deque, both with
  **lazy tombstones** — removal just drops the dict entry; stale uids
  are skipped (and compacted away) when they surface,
* a lazy min-heap for the load-shedding victim
  (``(priority, -submit_seq)``: lowest priority, ties youngest-first —
  exactly the old ``min()`` scan), and
* a min-heap of deadline expiries, so a tick pays O(expired) for TTL
  enforcement instead of scanning the whole queue.

**Iteration order is observable API**: preempted requeues first (most
recently preempted at the head, matching the old ``insert(0)``), then
everything else in arrival order. ``len`` / ``in`` / indexing behave
like the old list (indexing is O(n) — it exists for tests and
diagnostics, not hot paths).

**Admission order** (:meth:`admission_order`) is where policy lives and
is deliberately distinct from iteration order: preempted requeues hold
an admission promise and always go first; then the highest non-empty
priority class; within a class, tenants take turns (round-robin, the
turn pointer advancing on every admission) so one tenant flooding the
queue cannot starve another of the same class. With the defaults —
every request priority 0, tenant ``""`` — this degenerates to exact
FIFO, so single-tenant traces schedule precisely as before.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Dict, Iterator, List, Optional, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.runtime.serve_loop import Request


class PendingQueue:
    """Deque + uid-index admission queue with lazy tombstones."""

    def __init__(self):
        self._by_uid: Dict[int, "Request"] = {}
        #: preempted-requeue uids; head = most recently preempted
        self._front: deque = deque()
        #: fresh-submission uids in arrival order
        self._arrival: deque = deque()
        #: priority class → tenant → uid deque (arrival order)
        self._classes: Dict[int, Dict[str, deque]] = {}
        #: priority class → tenant round-robin order (head admits next)
        self._rr: Dict[int, deque] = {}
        #: (priority, -submit_seq, uid) — lazy shed-victim heap
        self._shed_heap: List = []
        #: (expiry_time, uid) — lazy deadline heap
        self._deadline_heap: List = []

    # --- container protocol (list-compatible surface) ------------------

    def __len__(self) -> int:
        return len(self._by_uid)

    def __bool__(self) -> bool:
        return bool(self._by_uid)

    def __contains__(self, uid: int) -> bool:
        return uid in self._by_uid

    def __iter__(self) -> Iterator["Request"]:
        seen = set()
        for uid in self._front:
            req = self._by_uid.get(uid)
            if req is not None and uid not in seen:
                seen.add(uid)
                yield req
        for uid in self._arrival:
            req = self._by_uid.get(uid)
            if req is not None and uid not in seen:
                seen.add(uid)
                yield req

    def __getitem__(self, idx):
        # O(n); exists for tests/diagnostics (`pending[0]`,
        # `pending[-1]`), never on the engine's hot paths.
        return list(self)[idx]

    def get(self, uid: int) -> Optional["Request"]:
        return self._by_uid.get(uid)

    # --- mutation ------------------------------------------------------

    def append(self, req: "Request") -> None:
        """Fresh submission: arrival order, policy class, shed and
        deadline heaps."""
        self._by_uid[req.uid] = req
        self._arrival.append(req.uid)
        cls = self._classes.setdefault(req.priority, {})
        tenant = getattr(req, "tenant", "")
        if tenant not in cls:
            cls[tenant] = deque()
            self._rr.setdefault(req.priority, deque()).append(tenant)
        cls[tenant].append(req.uid)
        heapq.heappush(
            self._shed_heap, (req.priority, -req._submit_seq, req.uid)
        )
        self._push_deadline(req)

    def requeue_front(self, req: "Request") -> None:
        """Preemption requeue: admitted before everything else, most
        recently preempted first (the old ``insert(0)`` semantics)."""
        self._by_uid[req.uid] = req
        self._front.appendleft(req.uid)
        # still sheddable and still expirable while requeued
        heapq.heappush(
            self._shed_heap, (req.priority, -req._submit_seq, req.uid)
        )
        self._push_deadline(req)

    def remove(self, uid: int) -> Optional["Request"]:
        """Drop ``uid`` (admitted / cancelled / shed / expired).
        Amortized O(1): order deques and heaps keep tombstones that
        compaction sweeps once garbage dominates."""
        req = self._by_uid.pop(uid, None)
        if req is not None:
            self._maybe_compact()
        return req

    # --- policy --------------------------------------------------------

    def admission_order(self, limit: int) -> List["Request"]:
        """Up to ``limit`` candidates in admission-policy order:
        preempted requeues (FIFO among themselves), then priority
        classes high→low with per-tenant round-robin inside a class."""
        out: List["Request"] = []
        self._clean_head(self._front)
        # a request preempted k times has k entries in _front (each
        # requeue appends; the head one is the most recent) — dedup or
        # one Request could be handed two slots in the same pass
        seen: set = set()
        for uid in self._front:
            if len(out) >= limit:
                return out
            req = self._by_uid.get(uid)
            if req is not None and uid not in seen:
                seen.add(uid)
                out.append(req)
        for prio in sorted(self._classes, reverse=True):
            if len(out) >= limit:
                break
            rr = self._rr[prio]
            cls = self._classes[prio]
            # per-tenant cursor into this class's deque (skipping
            # tombstones); rr order decides whose turn is next
            iters = {
                t: (r for u in cls[t]
                    if (r := self._by_uid.get(u)) is not None
                    and u not in self._front)
                for t in rr
            }
            exhausted: set = set()
            while len(out) < limit and len(exhausted) < len(rr):
                for t in list(rr):
                    if t in exhausted or len(out) >= limit:
                        continue
                    nxt = next(iters[t], None)
                    if nxt is None:
                        exhausted.add(t)
                    else:
                        out.append(nxt)
        return out

    def note_admitted(self, req: "Request") -> None:
        """Advance the tenant round-robin: the admitted request's tenant
        goes to the back of its class's turn order."""
        rr = self._rr.get(req.priority)
        tenant = getattr(req, "tenant", "")
        if rr and rr[0] == tenant:
            rr.rotate(-1)
        elif rr and tenant in rr:
            rr.remove(tenant)
            rr.append(tenant)

    def shed_victim(self) -> Optional["Request"]:
        """Peek the load-shedding victim: lowest priority, ties broken
        youngest-first — identical to the old full-queue ``min()``."""
        while self._shed_heap:
            prio, nseq, uid = self._shed_heap[0]
            req = self._by_uid.get(uid)
            if req is None or (prio, -nseq) != (req.priority,
                                                req._submit_seq):
                heapq.heappop(self._shed_heap)
                continue
            return req
        return None

    def pop_expired(self, now: float) -> List["Request"]:
        """Remove and return every queued request whose TTL lapsed.
        O(expired · log n); requests without a deadline never enter the
        heap."""
        out: List["Request"] = []
        while self._deadline_heap and self._deadline_heap[0][0] <= now:
            _, uid = heapq.heappop(self._deadline_heap)
            req = self._by_uid.get(uid)
            if req is None or req.deadline_s is None \
                    or req._t_submit is None:
                continue
            expiry = req._t_submit + req.deadline_s
            if expiry > now:
                # deadline moved since the push; re-arm (strictly in
                # the future, so this cannot loop)
                heapq.heappush(self._deadline_heap, (expiry, uid))
                continue
            del self._by_uid[uid]
            out.append(req)
        if out:
            self._maybe_compact()
        return out

    # --- internals -----------------------------------------------------

    def _push_deadline(self, req: "Request") -> None:
        # requests without a deadline never enter the heap
        if req.deadline_s is not None and req._t_submit is not None:
            heapq.heappush(
                self._deadline_heap,
                (req._t_submit + req.deadline_s, req.uid),
            )

    def _clean_head(self, dq: deque) -> None:
        while dq and dq[0] not in self._by_uid:
            dq.popleft()

    def _maybe_compact(self) -> None:
        """Sweep tombstones once they dominate: every structure rebuilds
        in O(live + dead), and a sweep needs at least as many removals
        as it reclaims — amortized O(1) per operation."""
        live = max(len(self._by_uid), 16)
        if (len(self._arrival) + len(self._front)
                + len(self._shed_heap) <= 4 * live):
            return
        self._front = deque(
            u for u in self._front if u in self._by_uid
        )
        self._arrival = deque(
            u for u in self._arrival if u in self._by_uid
        )
        for prio in list(self._classes):
            cls = self._classes[prio]
            for t in list(cls):
                cls[t] = deque(
                    u for u in cls[t] if u in self._by_uid
                )
            if all(not d for d in cls.values()):
                del self._classes[prio]
                del self._rr[prio]
        self._shed_heap = [
            (p, s, u) for (p, s, u) in self._shed_heap
            if (r := self._by_uid.get(u)) is not None
            and (p, -s) == (r.priority, r._submit_seq)
        ]
        heapq.heapify(self._shed_heap)
        self._deadline_heap = [
            (t, u) for (t, u) in self._deadline_heap
            if u in self._by_uid
        ]
        heapq.heapify(self._deadline_heap)

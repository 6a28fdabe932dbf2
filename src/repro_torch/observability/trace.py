"""Structured event tracing for the serving runtime (port of
``repro.observability.trace``).

An `EventTrace` is a bounded ring buffer of typed, timestamped events
emitted by `ServeLoop` (admission, prefill waves, decode ticks,
preemption, CoW, lifecycle terminals), `PageAllocator` (cache-page
evictions) and `FaultInjector` (every injected fault, tagged with its
site). Events carry the engine *tick* plus a monotonic sequence number,
and wall-clock time lives only in the `t`/`dur` fields — so
`EventTrace.signature()` (everything except wall-clock) is a pure
function of the request trace and the chaos seed, and two fixed-seed
runs produce identical signatures (tested).

`export_chrome_trace` converts a trace into the Chrome/Perfetto trace
event JSON format (load the file in `ui.perfetto.dev` or
`chrome://tracing`): one lane per engine slot showing request-residency
spans (admit → finish/preempt/cancel/expire/quarantine) with instant
markers for lifecycle events, a scheduler lane with decode-tick and
prefill-wave duration spans, an allocator lane (page evictions), a
chaos lane (injected faults), and counter tracks for pool occupancy /
queue depth / live slots. `validate_chrome_trace` is the schema check
CI and the tests share.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

#: Event names with a duration, rendered as complete ("X") spans on the
#: scheduler lane.
SPAN_EVENTS = ("decode_tick", "prefill_wave", "prefill_tick")

#: Event names rendered as Chrome counter ("C") tracks.
COUNTER_EVENTS = ("pool_occupancy", "queue_depth", "live_slots")

#: Lifecycle events that close a request's residency span on its slot
#: lane (see `export_chrome_trace`).
RELEASE_EVENTS = ("finish", "preempt", "cancel", "expire", "quarantine",
                  "shed")

_PID = 1
_TID_SCHED = 1
_TID_ALLOC = 2
_TID_CHAOS = 3
_TID_SLOT0 = 10  # slot i → tid _TID_SLOT0 + i


@dataclasses.dataclass
class TraceEvent:
    """One trace event. `t` is seconds since the trace epoch; `dur` is
    a span length in seconds (0 for instants). Everything except
    `t`/`dur` is deterministic for a fixed request trace + chaos seed.
    """

    seq: int
    name: str
    tick: int
    t: float
    dur: float = 0.0
    slot: Optional[int] = None
    uid: Optional[int] = None
    site: Optional[str] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def signature(self) -> Tuple:
        """The wall-clock-free identity of this event."""
        return (self.name, self.tick, self.slot, self.uid, self.site,
                tuple(sorted(self.args.items())))


class EventTrace:
    """Bounded ring buffer of `TraceEvent`s.

    The buffer keeps the most recent `capacity` events (`dropped`
    counts overwritten ones); `seq` keeps numbering globally so gaps
    are visible. The emitter owns `tick` — `ServeLoop` sets it at the
    top of every scheduling round so every event lands on the tick that
    produced it.
    """

    def __init__(self, capacity: int = 65536):
        if capacity <= 0:
            raise ValueError(f"capacity={capacity}")
        self.capacity = capacity
        self._events: "deque[TraceEvent]" = deque(maxlen=capacity)
        self._seq = 0
        self.dropped = 0
        self.tick = 0
        self._t0 = time.perf_counter()

    def emit(self, name: str, *, dur: float = 0.0,
             slot: Optional[int] = None, uid: Optional[int] = None,
             site: Optional[str] = None, **args) -> TraceEvent:
        ev = TraceEvent(
            seq=self._seq, name=name, tick=self.tick,
            t=time.perf_counter() - self._t0, dur=float(dur),
            slot=slot, uid=uid, site=site, args=args,
        )
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)
        self._seq += 1
        return ev

    @property
    def events(self) -> List[TraceEvent]:
        return list(self._events)

    def signature(self) -> List[Tuple]:
        """Wall-clock-free event sequence; identical across fixed-seed
        replays of the same request trace."""
        return [ev.signature() for ev in self._events]

    def __len__(self) -> int:
        return len(self._events)


def _us(seconds: float) -> float:
    return round(seconds * 1e6, 3)


def export_chrome_trace(trace: EventTrace,
                        path: Optional[str] = None) -> Dict[str, Any]:
    """Render `trace` as a Chrome/Perfetto trace-event JSON document.

    Returns the document (``{"traceEvents": [...], ...}``) and, when
    `path` is given, also writes it there. Lanes: one tid per engine
    slot (request-residency spans + lifecycle instants), a scheduler
    lane (decode_tick / prefill_wave spans and unslotted instants), an
    allocator lane, a chaos lane, plus counter tracks.
    """
    events: List[Dict[str, Any]] = []
    used_tids: Dict[int, str] = {}

    def meta(name: str, args: Dict[str, Any], tid: int = 0):
        events.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": name, "args": args})

    def lane(tid: int, label: str):
        if tid not in used_tids:
            used_tids[tid] = label

    def slot_tid(slot: int) -> int:
        tid = _TID_SLOT0 + slot
        lane(tid, f"slot {slot}")
        return tid

    open_spans: Dict[int, TraceEvent] = {}
    t_end = 0.0

    for ev in trace.events:
        t_end = max(t_end, ev.t + ev.dur)
        common = {"pid": _PID, "ts": _us(ev.t)}
        args: Dict[str, Any] = {"tick": ev.tick, "seq": ev.seq}
        if ev.uid is not None:
            args["uid"] = ev.uid
        if ev.site is not None:
            args["site"] = ev.site
        args.update(ev.args)

        if ev.name in COUNTER_EVENTS:
            lane(_TID_SCHED, "scheduler")
            events.append({**common, "ph": "C", "tid": _TID_SCHED,
                           "name": ev.name,
                           "args": {"value": ev.args.get("value", 0)}})
            continue
        if ev.name in SPAN_EVENTS:
            lane(_TID_SCHED, "scheduler")
            events.append({**common, "ph": "X", "tid": _TID_SCHED,
                           "name": ev.name,
                           "dur": max(_us(ev.dur), 1.0), "args": args})
            continue

        if ev.name == "page_evict":
            tid = _TID_ALLOC
            lane(tid, "allocator")
        elif ev.name == "fault_injected":
            tid = _TID_CHAOS
            lane(tid, "chaos")
        elif ev.slot is not None:
            tid = slot_tid(ev.slot)
        else:
            tid = _TID_SCHED
            lane(tid, "scheduler")
        events.append({**common, "ph": "i", "tid": tid, "s": "t",
                       "name": ev.name, "args": args})

        # request-residency spans per slot lane
        if ev.slot is not None:
            if ev.name == "admit":
                open_spans[ev.slot] = ev
            elif ev.name in RELEASE_EVENTS:
                start = open_spans.pop(ev.slot, None)
                if start is not None:
                    events.append({
                        "ph": "X", "pid": _PID, "tid": slot_tid(ev.slot),
                        "ts": _us(start.t),
                        "dur": max(_us(ev.t - start.t), 1.0),
                        "name": f"req {start.uid}"
                        if start.uid is not None else "req",
                        "args": {"uid": start.uid,
                                 "admit_tick": start.tick,
                                 "release": ev.name,
                                 "release_tick": ev.tick},
                    })

    # close spans still open at the end of the trace
    for slot, start in sorted(open_spans.items()):
        events.append({
            "ph": "X", "pid": _PID, "tid": slot_tid(slot),
            "ts": _us(start.t), "dur": max(_us(t_end - start.t), 1.0),
            "name": f"req {start.uid}" if start.uid is not None
            else "req",
            "args": {"uid": start.uid, "admit_tick": start.tick,
                     "release": "open"},
        })

    meta("process_name", {"name": "energon-serve"})
    order = sorted(used_tids)
    for sort_index, tid in enumerate(order):
        meta("thread_name", {"name": used_tids[tid]}, tid=tid)
        meta("thread_sort_index", {"sort_index": sort_index}, tid=tid)

    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "emitted": trace._seq,
            "retained": len(trace),
            "dropped": trace.dropped,
        },
    }
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


def validate_chrome_trace(doc: Dict[str, Any]) -> None:
    """Schema-check a Chrome trace document; raises ValueError on the
    first violation. Shared by the test suite and the CI bench smoke.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace document must contain 'traceEvents'")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        ph = ev.get("ph")
        if ph not in ("X", "i", "C", "M"):
            raise ValueError(f"event {i}: bad ph {ph!r}")
        for key in ("name", "pid"):
            if key not in ev:
                raise ValueError(f"event {i} ({ph}): missing {key!r}")
        if ph == "M":
            if not isinstance(ev.get("args"), dict):
                raise ValueError(f"event {i}: metadata without args")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if "tid" not in ev:
            raise ValueError(f"event {i}: missing tid")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: X without valid dur")
        if ph == "i" and ev.get("s") not in ("t", "p", "g"):
            raise ValueError(f"event {i}: instant without scope")
        if ph == "C":
            args = ev.get("args")
            if (not isinstance(args, dict) or not args or
                    not all(isinstance(v, (int, float))
                            for v in args.values())):
                raise ValueError(f"event {i}: counter without numeric "
                                 "args")

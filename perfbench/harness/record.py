"""What one run saw, as the metric readers read it.

Times are host ``perf_counter`` seconds. The serving records come from
the harness's own bookkeeping of the requests it sent (the time each
token reached its ``on_token`` hook), not from the program's counters;
the traced steps' program counters sit apart, in ``engine``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class RequestRecord:
    uid: int
    due: float                  # when it was due (absolute)
    prompt_len: int
    temperature: float
    #: prompt tokens the cache already holds when it arrives (a shared
    #: system prompt, a session's document)
    cached: int = 0
    token_times: List[float] = dataclasses.field(default_factory=list)
    state: str = "new"


@dataclasses.dataclass
class CallRecord:
    start: float
    end: float
    tokens: int


@dataclasses.dataclass
class TickRecord:
    """One traced engine step: the cache length of every decode step it
    ran (after its append), and the rows ``(start, end)`` of every
    prefill chunk it ran."""

    decode_lengths: List[int] = dataclasses.field(default_factory=list)
    prefill_rows: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    #: how many of the prefill chunks end their prompts
    prefill_finishing: int = 0


@dataclasses.dataclass
class Run:
    kind: str
    spec: Dict
    mix: Dict
    seconds: float
    setup_s: float = 0.0
    window: Tuple[float, float] = (0.0, 0.0)
    #: when the harness stopped waiting for late first tokens
    censor_time: float = 0.0
    requests: List[RequestRecord] = dataclasses.field(default_factory=list)
    calls: List[CallRecord] = dataclasses.field(default_factory=list)
    traced_calls: List[CallRecord] = dataclasses.field(default_factory=list)
    #: the steps of the profiled span
    ticks: List[TickRecord] = dataclasses.field(default_factory=list)
    #: the steps of the window's steady stretch before the profiler
    #: starts, and the engine's counters over them
    steady_ticks: List[TickRecord] = dataclasses.field(default_factory=list)
    engine: Dict[str, float] = dataclasses.field(default_factory=dict)
    tracer: Optional[object] = None
    #: (seconds into the window, requests queued) every half second
    backlog: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)
    #: the engine's shape (slots, prefill chunk, cache rows)
    shape: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self, t: float) -> bool:
        return self.window[0] <= t < self.window[1]

"""Fault tolerance (port of ``repro.runtime.fault_tolerance``): the
serving engine's resilience primitives.

* transient failures → bounded retry with exponential backoff around a
  step dispatch (`retry_step`, parameterized by `RetryPolicy`);
* preemption signals → `PreemptionHandler`, a SIGTERM/SIGINT flag a
  loop checks each step;
* stragglers → `StragglerMonitor` keeps a robust (median/MAD) estimate
  of step times and flags outliers.

`ServeLoop` (:mod:`repro_torch.runtime.serve_loop`) retries its decode
and prefill dispatches under a `RetryPolicy`, records tick times in a
`StragglerMonitor`, and contains per-request failures (NaN quarantine,
cancellation, deadline eviction).

`FaultInjector` is the deterministic chaos hook threaded through the
serving engine: every fault site (page allocation, step dispatch,
logits, tick pacing, the preemption policy) consults the injector,
whose draws come from one seeded numpy Generator — a given (engine
config, trace, seed) triple replays the exact same fault schedule on
every run, and the sites draw in the reference's order, so one seed
gives one schedule in both packages. Under the hybrid scheduler the
same sites fire *inside* hybrid ticks: ``poison_prefill`` at each job's
completion tail, ``poison_decode``/``step_delay`` on the interleaved
decode step, and storms/alloc denials against slots that may be
mid-prefill — survivors stream bit-identically to the fault-free run
under either scheduler.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class StepFailure(Exception):
    """A step failed even after its retry budget was exhausted."""


class TransientStepError(RuntimeError):
    """A retriable, injected-or-transient failure raised *before* a step
    dispatches (the cache is not yet written, so the retry is safe)."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential-backoff retry parameters."""

    max_retries: int = 3
    base_delay: float = 0.5
    retriable: Tuple[type, ...] = (RuntimeError, OSError)


def retry_step(
    fn: Callable,
    *args,
    policy: Optional[RetryPolicy] = None,
    max_retries: int = 3,
    base_delay: float = 0.5,
    retriable=(RuntimeError, OSError),
    on_retry: Optional[Callable[[int, Exception], None]] = None,
):
    """Run ``fn(*args)`` with bounded exponential-backoff retries.

    ``policy`` overrides the individual keyword parameters when given.
    """
    if policy is not None:
        max_retries = policy.max_retries
        base_delay = policy.base_delay
        retriable = policy.retriable
    for attempt in range(max_retries + 1):
        try:
            return fn(*args)
        except retriable as exc:  # noqa: PERF203
            if attempt == max_retries:
                raise StepFailure(
                    f"step failed after {max_retries} retries: {exc}"
                ) from exc
            if on_retry:
                on_retry(attempt, exc)
            if base_delay > 0:
                time.sleep(base_delay * (2 ** attempt))


class StragglerMonitor:
    """Robust (median/MAD) step-time outlier detection."""

    def __init__(self, window: int = 50, threshold: float = 3.0):
        self.window = window
        self.threshold = threshold
        self.times: List[float] = []
        self.flagged: List[int] = []
        self._step = 0

    def record(self, seconds: float) -> bool:
        """Record one step time; returns True if it is a straggler."""
        self._step += 1
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < 10:
            return False
        sorted_t = sorted(self.times)
        median = sorted_t[len(sorted_t) // 2]
        mad = sorted(abs(t - median) for t in sorted_t)[len(sorted_t) // 2]
        limit = median + self.threshold * max(mad, 0.05 * median, 1e-4)
        is_straggler = seconds > limit
        if is_straggler:
            self.flagged.append(self._step)
        return is_straggler

    @property
    def median_step_time(self) -> float:
        if not self.times:
            return 0.0
        return sorted(self.times)[len(self.times) // 2]


class PreemptionHandler:
    """SIGTERM/SIGINT → graceful save-and-exit flag.

    A loop checks ``should_stop`` each step and winds down before
    exiting.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = False
        self._installed = False
        self._signals = signals

    def install(self):
        if self._installed:
            return
        for sig in self._signals:
            try:
                signal.signal(sig, self._handler)
            except ValueError:
                pass  # not main thread (tests)
        self._installed = True

    def _handler(self, signum, frame):
        self._stop = True

    def request_stop(self):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-site fault rates for a chaos run. All rates are per-draw
    probabilities in [0, 1]; a zero rate disables the site entirely (no
    RNG draw, so adding a new site never perturbs old schedules)."""

    #: P[a page allocation that would actually grow a slot is denied] —
    #: surfaces as pool exhaustion (wait at admission / preempt at decode).
    alloc_failure: float = 0.0
    #: P[a fresh step dispatch raises ``TransientStepError``]; the engine
    #: retries under its ``RetryPolicy``.
    step_exception: float = 0.0
    #: Max *consecutive* injected failures per dispatch. Keep this at or
    #: below the engine's ``RetryPolicy.max_retries`` so every injected
    #: burst is recoverable by construction.
    step_exception_burst: int = 2
    #: P[a live slot's decode logits are poisoned with NaN this tick] —
    #: exercises the quarantine guard; the poisoned request fails.
    nan_logits: float = 0.0
    #: P[a fresh slot's final prefill logits are poisoned with NaN].
    nan_prefill: float = 0.0
    #: P[an injected straggler sleep of ``delay_seconds`` after a step].
    delay: float = 0.0
    delay_seconds: float = 0.02
    #: P[a forced preemption storm at tick start] evicting up to
    #: ``preempt_storm_size`` youngest live slots.
    preempt_storm: float = 0.0
    preempt_storm_size: int = 2


class FaultInjector:
    """Seeded, deterministic chaos source for the serving engine.

    Every fault site consults the injector through one of the methods
    below; all randomness comes from a single ``np.random.default_rng``
    seeded at construction, so for a deterministic engine + trace the
    whole fault schedule — which allocation fails, which dispatch
    raises, which slot's logits go NaN, when the preemption storm hits —
    is a pure function of the seed. ``counts`` tallies every injected
    event for benches and assertions.

    ``tracer`` — optional :class:`~repro_torch.observability.trace.EventTrace`
    hook (set by the engine's observability layer). Every fault that
    actually fires emits one ``fault_injected`` event tagged with its
    site; the injector's RNG is never consulted for tracing, so attaching
    a tracer cannot perturb a seeded fault schedule.
    """

    def __init__(self, seed: int = 0, spec: Optional[FaultSpec] = None):
        self.seed = int(seed)
        self.spec = spec if spec is not None else FaultSpec()
        self._rng = np.random.default_rng(self.seed)
        self._burst = 0
        self.tracer = None
        self.counts: Dict[str, int] = {
            "alloc_failure": 0,
            "step_exception": 0,
            "nan_logits": 0,
            "nan_prefill": 0,
            "delay": 0,
            "preempt_storm": 0,
        }

    def _draw(self, p: float) -> bool:
        if p <= 0.0:
            return False
        return bool(self._rng.random() < p)

    def _note(self, site: str, n: int = 1) -> None:
        self.counts[site] += n
        if self.tracer is not None and n > 0:
            self.tracer.emit("fault_injected", site=site, n=n)

    def alloc_failure(self) -> bool:
        """Whether to deny a page allocation that would actually grow a
        slot (the caller must only consult on real growth — denying a
        no-op would fabricate preemptions out of thin air)."""
        if self._draw(self.spec.alloc_failure):
            self._note("alloc_failure")
            return True
        return False

    def step_fault(self, fresh: bool) -> bool:
        """Whether this step *attempt* fails. ``fresh`` marks the first
        attempt of a dispatch: only a fresh attempt can start a new
        failure burst, so consecutive injected failures per dispatch are
        bounded by ``step_exception_burst`` and the engine's retry
        budget always converges."""
        if self._burst > 0:
            self._burst -= 1
            self._note("step_exception")
            return True
        if fresh and self._draw(self.spec.step_exception):
            burst = max(int(self.spec.step_exception_burst), 1)
            self._burst = int(self._rng.integers(0, burst))
            self._note("step_exception")
            return True
        return False

    def poison_decode(self, uids: Sequence[int]) -> List[int]:
        """Uids (among this tick's live slots) whose decode logits are
        replaced with NaN before sampling."""
        hit = [u for u in uids if self._draw(self.spec.nan_logits)]
        self._note("nan_logits", len(hit))
        return hit

    def poison_prefill(self, uids: Sequence[int]) -> List[int]:
        """Uids (among this wave's fresh admissions) whose final prefill
        logits are replaced with NaN before first-token sampling."""
        hit = [u for u in uids if self._draw(self.spec.nan_prefill)]
        self._note("nan_prefill", len(hit))
        return hit

    def step_delay(self) -> float:
        """Injected straggler sleep (seconds) after a step; 0 = none."""
        if self._draw(self.spec.delay):
            self._note("delay")
            return float(self.spec.delay_seconds)
        return 0.0

    def preempt_storm(self, n_live: int) -> int:
        """Number of youngest live slots to force-preempt this tick."""
        if n_live > 0 and self._draw(self.spec.preempt_storm):
            n = min(int(self.spec.preempt_storm_size), n_live)
            self._note("preempt_storm", n)
            return n
        return 0

    @property
    def total_injected(self) -> int:
        return sum(self.counts.values())

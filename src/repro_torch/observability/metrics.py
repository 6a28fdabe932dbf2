"""Metrics primitives (port of ``repro.observability.metrics``):
counters, gauges, streaming histograms, and a registry with
JSON-snapshot + Prometheus-text exporters.

The registry is the single metrics substrate for the serving runtime:
`EngineMetrics` (repro_torch.runtime.serve_loop) is a thin attribute facade
over a `MetricsRegistry`, and the observability layer's sparsity and
latency distributions land in the same registry, so one
`registry.snapshot()` (or `prometheus_text()`) captures the whole
engine state.

Histograms are *streaming* with fixed bucket bounds chosen at
construction: `observe` is O(#buckets) worst case (a bisect), memory is
O(#buckets) forever — this is what lets `EngineMetrics` fold unbounded
per-request latency series into bounded state.
Percentiles are estimated by linear interpolation inside the bucket
containing the target rank, with the observed min/max tightening the
open-ended edge buckets; the estimation error is bounded by the width
of that bucket (tested against a numpy oracle).
"""

from __future__ import annotations

import bisect
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

Number = Union[int, float]

#: Latency bucket bounds in seconds: geometric-ish 100 µs → 60 s, the
#: range a serving tick or request latency realistically spans.
DEFAULT_LATENCY_BOUNDS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: Keep-ratio bucket bounds: ρ_eff lives in [0, 1]; 0.05-wide buckets.
RHO_BOUNDS: Tuple[float, ...] = tuple(
    round(0.05 * i, 2) for i in range(1, 21)
)


class Counter:
    """A monotonically *intended* counter. `value` is directly
    assignable (the `EngineMetrics` facade does `metrics.x += 1` via
    `setattr`), so monotonicity is by convention, not enforcement."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n


class Gauge:
    """A point-in-time value; tracks its own peak for report lines."""

    __slots__ = ("name", "help", "value", "peak")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Number = 0
        self.peak: Number = 0

    def set(self, v: Number) -> None:
        self.value = v
        if v > self.peak:
            self.peak = v


class Histogram:
    """Fixed-bound streaming histogram.

    Buckets partition the reals as ``(-inf, b0], (b0, b1], ...,
    (b_{n-1}, +inf)`` — `counts` has ``len(bounds) + 1`` entries. The
    running `sum`, `count`, `min` and `max` ride along so means and
    edge-bucket interpolation stay exact-ish without retaining samples.
    """

    __slots__ = ("name", "help", "bounds", "counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, bounds: Sequence[float],
                 help: str = ""):
        b = tuple(float(x) for x in bounds)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"bounds must be strictly increasing: {b}")
        self.name = name
        self.help = help
        self.bounds = b
        self.counts: List[int] = [0] * (len(b) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: Number) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    def percentile(self, p: float) -> float:
        """Estimate the p-th percentile (p in [0, 100]) by linear
        interpolation within the bucket holding the target rank."""
        if self.count == 0:
            return 0.0
        rank = (p / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else self.min
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo = max(lo, self.min) if self.min is not None else lo
                hi = min(hi, self.max) if self.max is not None else hi
                if hi <= lo:
                    return float(lo)
                frac = (rank - cum) / c
                return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
            cum += c
        return float(self.max if self.max is not None else 0.0)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Named metric store with get-or-create accessors.

    Accessors are idempotent: `counter("x")` returns the same object on
    every call, and asking for an existing name with a different metric
    type (or different histogram bounds) raises — silent aliasing would
    corrupt whichever caller came second.
    """

    def __init__(self):
        self._metrics: "Dict[str, Union[Counter, Gauge, Histogram]]" = {}

    def _get(self, name: str, kind, factory):
        m = self._metrics.get(name)
        if m is None:
            m = factory()
            self._metrics[name] = m
            return m
        if not isinstance(m, kind):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {kind.__name__}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name, help))

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_LATENCY_BOUNDS,
                  help: str = "") -> Histogram:
        h = self._get(name, Histogram,
                      lambda: Histogram(name, bounds, help))
        if h.bounds != tuple(float(b) for b in bounds):
            raise ValueError(
                f"histogram {name!r} re-requested with different "
                f"bounds"
            )
        return h

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        return list(self._metrics)

    # --- exporters -----------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """JSON-serializable snapshot of every metric."""
        out: Dict[str, dict] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Counter):
                out[name] = {"type": "counter", "value": m.value}
            elif isinstance(m, Gauge):
                out[name] = {"type": "gauge", "value": m.value,
                             "peak": m.peak}
            else:
                out[name] = {
                    "type": "histogram",
                    "count": m.count,
                    "sum": m.sum,
                    "min": m.min,
                    "max": m.max,
                    "buckets": [
                        {"le": (m.bounds[i] if i < len(m.bounds)
                                else "+Inf"),
                         "count": c}
                        for i, c in enumerate(m.counts)
                    ],
                    "p50": m.percentile(50),
                    "p95": m.percentile(95),
                    "p99": m.percentile(99),
                }
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        for name, m in self._metrics.items():
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_fmt(m.value)}")
            else:
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for i, c in enumerate(m.counts[:-1]):
                    cum += c
                    lines.append(
                        f'{pname}_bucket{{le="{_fmt(m.bounds[i])}"}} '
                        f"{cum}"
                    )
                cum += m.counts[-1]
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{pname}_sum {_fmt(m.sum)}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + "\n"

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)

    def merge(self, other: "MetricsRegistry",
              rename=None) -> "MetricsRegistry":
        """Fold ``other``'s metrics into this registry, by type:

        * counters **add** (tokens, dispatches, preemptions — extensive
          quantities);
        * gauges take the **max** of value and peak — a mesh run's peak
          pages in use is the busiest replica's watermark, never the
          sum (each replica owns a disjoint pool);
        * histograms add pointwise (same bounds required — the usual
          bounds-mismatch error applies).

        ``rename`` maps source names to target names (e.g.
        :func:`strip_replica_prefix` collapses ``replica3/serve_x`` and
        ``replica1/serve_x`` into one cross-replica ``serve_x``
        aggregate); returning ``None`` skips that metric (so an
        aggregate pass can ignore names that were never namespaced
        instead of double-counting them); identity when omitted.
        Returns ``self``.
        """
        for name, m in other._metrics.items():
            tgt = rename(name) if rename is not None else name
            if tgt is None:
                continue
            if isinstance(m, Counter):
                self.counter(tgt, m.help).value += m.value
            elif isinstance(m, Gauge):
                g = self.gauge(tgt, m.help)
                g.value = max(g.value, m.value)
                g.peak = max(g.peak, m.peak)
            else:
                h = self.histogram(tgt, m.bounds, m.help)
                for i, c in enumerate(m.counts):
                    h.counts[i] += c
                h.count += m.count
                h.sum += m.sum
                if m.min is not None:
                    h.min = m.min if h.min is None else min(h.min, m.min)
                if m.max is not None:
                    h.max = m.max if h.max is None else max(h.max, m.max)
        return self


_REPLICA_RE = re.compile(r"^replica\d+/")


def strip_replica_prefix(name: str) -> str:
    """``replica3/serve_x`` → ``serve_x`` (identity for unprefixed
    names) — the rename hook for cross-replica aggregate merges."""
    return _REPLICA_RE.sub("", name)


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _PROM_BAD.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _fmt(v: Number) -> str:
    if isinstance(v, int):
        return str(v)
    return repr(float(v))

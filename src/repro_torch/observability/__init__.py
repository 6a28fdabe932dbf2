"""Serving-runtime observability (port of ``repro.observability``):
event tracing, sparsity telemetry, metrics registry + exporters.

`Observability` is the facade `ServeLoop` takes: it bundles an
`EventTrace` (bounded ring buffer + Chrome/Perfetto exporter), a
`MetricsRegistry` (counters / gauges / streaming histograms with JSON
and Prometheus exporters — `EngineMetrics` registers its counters here
so one snapshot covers the whole engine), a `SparsityAggregator` for
the runtime-effective MP-MRF keep ratio ρ_eff, and bounded per-tick
time series (pool occupancy, queue depth, live slots).

Construction is cheap and everything is host-side; the *device* side
(per-dispatch survivor-block counts) only engages when the engine is
built with an `Observability` whose `device_telemetry` is on, via
separate `telemetry=True` steps (graphed steps of their own on CUDA) —
an engine without one dispatches exactly the steps it did before and
emits nothing (tested).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.observability.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BOUNDS,
    RHO_BOUNDS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    strip_replica_prefix,
)
from repro_torch.observability.sparsity import (  # noqa: F401
    STAT_FIELDS,
    SparsityAggregator,
)
from repro_torch.observability.trace import (  # noqa: F401
    COUNTER_EVENTS,
    RELEASE_EVENTS,
    SPAN_EVENTS,
    EventTrace,
    TraceEvent,
    export_chrome_trace,
    validate_chrome_trace,
)


class Observability:
    """Bundle of trace + registry + sparsity aggregation + time series
    that the serving engine records into.

    Args:
      trace_capacity: ring-buffer size of the event trace.
      series_capacity: retained points per per-tick time series.
      device_telemetry: let the engine build ``telemetry=True`` step
        functions (per-dispatch survivor counts). Off ⇒ events and
        host metrics only; the model dispatches stay untouched.
    """

    def __init__(self, trace_capacity: int = 65536,
                 series_capacity: int = 16384,
                 device_telemetry: bool = True,
                 registry: Optional[MetricsRegistry] = None):
        self.trace = EventTrace(trace_capacity)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.sparsity = SparsityAggregator()
        self.device_telemetry = bool(device_telemetry)
        self.series: Dict[str, "deque[Tuple[int, int]]"] = {
            name: deque(maxlen=series_capacity)
            for name in COUNTER_EVENTS
        }

    # --- per-tick series ----------------------------------------------

    def record_tick_series(self, tick: int, *, pool_occupancy: int,
                           queue_depth: int, live_slots: int) -> None:
        """Record one scheduling round's gauges: appends to the bounded
        series, updates registry gauges, and emits counter events so
        the Chrome trace gets counter tracks."""
        values = {"pool_occupancy": pool_occupancy,
                  "queue_depth": queue_depth,
                  "live_slots": live_slots}
        for name, v in values.items():
            self.series[name].append((tick, int(v)))
            self.registry.gauge(f"serve_{name}").set(int(v))
            self.trace.emit(name, value=int(v))

    def series_stats(self, name: str) -> Dict[str, float]:
        """p50 / peak / mean over a recorded series (zeros if empty)."""
        pts = self.series.get(name)
        if not pts:
            return {"p50": 0.0, "peak": 0.0, "mean": 0.0}
        vals = np.array([v for _, v in pts], np.float64)
        return {"p50": float(np.percentile(vals, 50)),
                "peak": float(vals.max()),
                "mean": float(vals.mean())}

    # --- sparsity -----------------------------------------------------

    def record_decode_stats(self, stats: np.ndarray,
                            slots: Optional[Sequence[int]]) -> None:
        if stats.size == 0 or (slots is not None and not len(slots)):
            return
        self.sparsity.record_decode(stats, slots)
        self._observe_rho("serve_rho_eff_decode", stats, slots)

    def record_prefill_stats(self, stats: np.ndarray) -> None:
        if stats.size == 0:
            return
        self.sparsity.record_prefill(stats)
        self._observe_rho("serve_rho_eff_prefill", stats, None)

    def _observe_rho(self, name: str, stats: np.ndarray,
                     slots: Optional[Sequence[int]]) -> None:
        s = np.asarray(stats, np.int64)
        if slots is not None:
            s = s[:, list(slots), :]
        selected = int(s[..., 0].sum())
        live = int(s[..., 1].sum())
        if live > 0:
            self.registry.histogram(name, RHO_BOUNDS).observe(
                selected / live
            )

    # --- export -------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """One JSON-serializable document: registry metrics, sparsity
        totals + ρ_eff, series summaries, trace accounting."""
        return {
            "schema": "energon-obs-v1",
            "metrics": self.registry.snapshot(),
            "sparsity": self.sparsity.snapshot(),
            "series": {name: self.series_stats(name)
                       for name in self.series},
            "trace": {"emitted": self.trace._seq,
                      "retained": len(self.trace),
                      "dropped": self.trace.dropped},
        }

    def export_chrome_trace(self, path: Optional[str] = None):
        return export_chrome_trace(self.trace, path)


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BOUNDS", "RHO_BOUNDS", "strip_replica_prefix",
    "EventTrace", "TraceEvent", "export_chrome_trace",
    "validate_chrome_trace", "SPAN_EVENTS", "COUNTER_EVENTS",
    "RELEASE_EVENTS", "STAT_FIELDS", "SparsityAggregator",
    "Observability",
]

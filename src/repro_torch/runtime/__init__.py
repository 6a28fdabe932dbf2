"""Serving runtime of the port: page pool, admission queue, engine,
fault tolerance."""

from repro_torch.runtime.fault_tolerance import (
    FaultInjector,
    FaultSpec,
    PreemptionHandler,
    RetryPolicy,
    StepFailure,
    StragglerMonitor,
    TransientStepError,
    retry_step,
)
from repro_torch.runtime.paged_cache import (
    PageAllocator,
    PagedLayout,
    attention_cache_bytes,
)
from repro_torch.runtime.pending import PendingQueue
from repro_torch.runtime.serve_loop import (
    EngineMetrics,
    EngineStalled,
    QueueFull,
    Request,
    ServeLoop,
    make_prefill_step,
    make_serve_step,
)

__all__ = [
    "EngineMetrics",
    "EngineStalled",
    "FaultInjector",
    "FaultSpec",
    "PageAllocator",
    "PagedLayout",
    "PendingQueue",
    "PreemptionHandler",
    "QueueFull",
    "Request",
    "RetryPolicy",
    "ServeLoop",
    "StepFailure",
    "StragglerMonitor",
    "TransientStepError",
    "attention_cache_bytes",
    "make_prefill_step",
    "make_serve_step",
    "retry_step",
]

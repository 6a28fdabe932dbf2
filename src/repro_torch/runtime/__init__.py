"""Serving runtime of the port: page pool, admission queue, engine."""

from repro_torch.runtime.paged_cache import (
    PageAllocator,
    PagedLayout,
    attention_cache_bytes,
)
from repro_torch.runtime.pending import PendingQueue
from repro_torch.runtime.serve_loop import (
    EngineMetrics,
    EngineStalled,
    Request,
    ServeLoop,
    make_prefill_step,
    make_serve_step,
)

__all__ = [
    "EngineMetrics",
    "EngineStalled",
    "PageAllocator",
    "PagedLayout",
    "PendingQueue",
    "Request",
    "ServeLoop",
    "attention_cache_bytes",
    "make_prefill_step",
    "make_serve_step",
]

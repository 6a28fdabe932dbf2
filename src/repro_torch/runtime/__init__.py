"""Runtime of the port: page pool, admission queue, serving engine,
replicated engines, fault tolerance and the training loop. The
reference's ``sample_tokens`` is ``ServeLoop._sample`` over
:mod:`repro_torch.core.prng`'s Threefry streams."""

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
    AllocatorInvariantError,
    PageAllocator,
    PagedLayout,
    attention_cache_bytes,
    clone_page_rows,
)
from repro_torch.runtime.pending import PendingQueue
from repro_torch.runtime.replicated_serve import (
    ReplicatedServeLoop,
    replica_home,
)
from repro_torch.runtime.serve_loop import (
    EngineMetrics,
    EngineStalled,
    QueueFull,
    Request,
    ServeLoop,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.runtime.train_loop import (
    TrainConfig,
    TrainLoop,
    make_train_step,
)

__all__ = [
    "AllocatorInvariantError",
    "EngineMetrics",
    "EngineStalled",
    "FaultInjector",
    "FaultSpec",
    "PageAllocator",
    "PagedLayout",
    "PendingQueue",
    "PreemptionHandler",
    "QueueFull",
    "ReplicatedServeLoop",
    "Request",
    "RetryPolicy",
    "ServeLoop",
    "StepFailure",
    "StragglerMonitor",
    "TrainConfig",
    "TrainLoop",
    "TransientStepError",
    "attention_cache_bytes",
    "clone_page_rows",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
    "replica_home",
    "retry_step",
]

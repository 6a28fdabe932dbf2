"""Distribution layer of the port (``repro.distributed``): the sharding
rules and the explicit layout over a ``(data, model)`` mesh, the
collectives, gradient compression and elastic resume. The pipeline over
a ``pod`` axis is ROADMAP A5b."""

from repro_torch.distributed.sharding import (  # noqa: F401
    ShardedLeaf,
    batch_shardings,
    cache_shardings,
    constrain_activations,
    data_axes,
    gather_tree,
    param_shardings,
    shard_tree,
)

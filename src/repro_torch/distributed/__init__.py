"""Distribution layer of the port (``repro.distributed``): the sharding
rules and the explicit layout over a ``(pod, data, model)`` mesh (or
any ordered subset of those axes), the collectives, gradient
compression, elastic resume and the GPipe pipeline over ``pod``."""

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

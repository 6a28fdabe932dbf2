"""GPipe pipeline parallelism over the ``pod`` axis (the reference's
``repro.distributed.pipeline``): not yet ported.

The reference streams microbatches through stages laid over a ``pod``
mesh axis; the port's :class:`~repro_torch.launch.mesh.Mesh` has the two
axes ``(data, model)``. Both functions raise, naming ROADMAP A5b, which
brings the named-axis mesh with ``pod`` and then this module.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.distributed.sharding import A5B


def pipeline_forward(stage_fn: Callable, stage_params: Any,
                     microbatches: Any, mesh: Any, axis: str = "pod"):
    """Refused: the GPipe schedule over ``axis`` is ROADMAP A5b."""
    raise NotImplementedError(f"pipeline_forward over {axis!r}: {A5B}")


def split_layers_to_stages(params_stacked: Any, num_stages: int):
    """Refused: splitting stacked layers into pipeline stages is
    ROADMAP A5b."""
    raise NotImplementedError(f"split_layers_to_stages: {A5B}")

"""GPipe pipeline parallelism over the ``pod`` axis (port of
``repro.distributed.pipeline``).

Stage s holds slab s of the stacked parameters (their leading dim is
the stage) on the ``axis`` device s, and microbatches stream through
the GPipe schedule: ``num_micro + S − 1`` ticks, each tick running every
stage on the activation it holds and moving its output to the next
stage's device (the reference's ``ppermute``); stage 0 takes in
microbatch t at tick t, and the last stage emits microbatch
``t − (S − 1)``. The single controller issues the stages of a tick one
after another; on distinct devices their kernels overlap, as the
reference's shard_map runs them in parallel.

The reference runs every stage on every tick and discards what the
bubble slots compute (stage s before tick s, and after tick
``num_micro + s − 1``); the port skips those slots, which changes no
output.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _on(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x if x.device == device else x.to(device)


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, microbatches: torch.Tensor, mesh,
                     axis: str = "pod") -> torch.Tensor:
    """Run ``stage_fn(params_for_one_stage, x) -> x`` as a pipeline over
    ``axis`` of ``mesh``.

    ``stage_params``: a tree (dicts, tuples, lists) whose tensor leaves
    have leading dim S = ``mesh.shape[axis]``; stage s reads slab
    ``leaf[s]`` on the device at index s of ``axis`` (0 on every other
    axis), a view where the leaf lives there. ``microbatches``: ``[M,
    micro_batch, …]`` activations. Returns ``[M, micro_batch, …]``, the
    last stage's outputs in microbatch order, on the mesh's first
    device."""
    num_stages = mesh.shape[axis]
    for leaf in _leaves(stage_params):
        if leaf.shape[0] != num_stages:
            raise ValueError(f"a stage-params leaf of leading dim "
                             f"{leaf.shape[0]} over {num_stages} stages")
    devices = [mesh.device({axis: s}) for s in range(num_stages)]
    slabs = [_tree_map(lambda a, s=s: _on(a[s], devices[s]), stage_params)
             for s in range(num_stages)]
    num_micro = microbatches.shape[0]
    outputs = [None] * num_micro
    held = [None] * num_stages          # the activation each stage holds
    for t in range(num_micro + num_stages - 1):
        if t < num_micro:
            held[0] = _on(microbatches[t], devices[0])
        moved = [None] * num_stages
        for s in range(num_stages):
            if held[s] is None:         # a bubble slot
                continue
            out = stage_fn(slabs[s], held[s])
            if s == num_stages - 1:
                outputs[t - (num_stages - 1)] = _on(out, mesh.first_device)
            else:
                moved[s + 1] = _on(out, devices[s + 1])
        held = moved
    return torch.stack(outputs)


def split_layers_to_stages(params_stacked: Any, num_stages: int) -> Any:
    """``[L, …]`` stacked layer params → ``[S, L/S, …]`` stage slabs
    (views); an L that S does not divide is refused."""

    def reshape(a):
        n = a.shape[0]
        if n % num_stages:
            raise ValueError(f"{n} layers not divisible by {num_stages} "
                             f"stages")
        return a.reshape(num_stages, n // num_stages, *a.shape[1:])

    return _tree_map(reshape, params_stacked)

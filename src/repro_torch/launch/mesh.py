"""Device meshes for serving and training (port of ``repro.launch.mesh``).

A :class:`Mesh` is a ``(data, model)`` grid of ``torch.device`` s with
one host controller over it. Serving: the ``data`` axis holds engine
replicas (one row each), the ``model`` axis the KV-head shards of a
replica's page pools. Training: the ``data`` axis splits the batch and
ZeRO-shards the weights, the ``model`` axis splits heads, MLP columns,
the vocabulary and the experts (``distributed/sharding.py``). Devices
may repeat — ``cuda:0`` four times is how four
devices are simulated on one card, ``cpu`` four times in the CPU tests
(the reference's ``--xla_force_host_platform_device_count``). The class
is the port's own: ``torch.distributed.DeviceMesh`` needs one process
per device and a process group, and the reference serves from a single
controller.

Building a mesh touches no device state beyond naming the devices, so
importing this module never initializes CUDA.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

AXES = ("data", "model")


def indexed_device(device) -> torch.device:
    """``cuda`` → ``cuda:<current>``: tensors report an indexed device,
    and the mesh's devices are compared with theirs."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ``(data, model)`` grid of devices, row-major: row r is replica
    r's model-axis devices. ``axis_names`` and ``shape`` (a dict, axis
    name → size) read as the reference's ``jax.sharding.Mesh``."""

    def __init__(self, devices: Sequence[Sequence], axis_names=AXES):
        rows = tuple(tuple(indexed_device(d) for d in row) for row in devices)
        if tuple(axis_names) != AXES:
            raise ValueError(
                f"the port's mesh has the two axes {AXES}, got "
                f"{tuple(axis_names)}: a 'pod' axis and three-axis meshes "
                f"are ROADMAP A5b")
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("mesh devices must form a non-empty grid")
        self.devices: Tuple[Tuple[torch.device, ...], ...] = rows
        self.axis_names = tuple(axis_names)
        self.shape = {self.axis_names[0]: len(rows),
                      self.axis_names[1]: len(rows[0])}

    def submesh(self, r: int) -> "Mesh":
        """Row ``r`` as a ``(1, model)`` mesh, the axes keeping their
        names (one replica's tensor-parallel mesh)."""
        return Mesh([self.devices[r]], self.axis_names)

    @property
    def physical_devices(self) -> Tuple[torch.device, ...]:
        """The distinct devices of the grid, in order of first use."""
        return tuple(dict.fromkeys(d for row in self.devices for d in row))

    def __repr__(self) -> str:
        dims = "x".join(str(v) for v in self.shape.values())
        names = ", ".join(str(d) for d in self.physical_devices)
        return f"Mesh({dims} {self.axis_names} over {names})"


def make_mesh(shape: Tuple[int, int], axis_names=AXES,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``shape = (D, M)`` mesh over the first D·M of ``devices``
    (default: every CUDA device of the host), row-major."""
    if len(tuple(shape)) != 2:
        raise ValueError(f"a mesh of shape {tuple(shape)}: the port's mesh "
                         f"has two axes; three-axis meshes are ROADMAP A5b")
    d, m = shape
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if d < 1 or m < 1 or len(devices) < d * m:
        raise ValueError(f"a {d}x{m} mesh needs {d * m} devices, got "
                         f"{len(devices)}")
    return Mesh([devices[r * m:(r + 1) * m] for r in range(d)], axis_names)



def make_host_mesh(model_axis: int = 1, devices: Optional[Sequence] = None
                   ) -> Mesh:
    """A ``(n // model_axis, model_axis)`` mesh over the host's n
    devices (default every CUDA device; a list such as ``["cpu"] * 8``
    or ``["cuda:0"] * 4`` simulates n), as the reference's
    ``make_host_mesh`` spans ``jax.devices()``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if model_axis < 1 or len(devices) < model_axis:
        raise ValueError(f"a model axis of {model_axis} over "
                         f"{len(devices)} devices")
    return make_mesh((len(devices) // model_axis, model_axis), AXES,
                     devices)

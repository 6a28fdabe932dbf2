"""Device meshes for serving and training (port of ``repro.launch.mesh``).

A :class:`Mesh` is a grid of ``torch.device`` s over named axes, any
ordered subset of ``("pod", "data", "model")``, with one host controller
over it. Serving: the ``data`` axis holds engine replicas (one row
each), the ``model`` axis the KV-head shards of a replica's page pools.
Training: ``pod`` and ``data`` split the batch (``pod`` folds into data
parallelism, as the reference's ``data_axes`` does), ``data`` alone
ZeRO-shards the weights, and ``model`` splits heads, MLP columns, the
vocabulary and the experts (``distributed/sharding.py``). The GPipe
pipeline (``distributed/pipeline.py``) can claim ``pod`` instead.

A *data row* is one point of the data axes (``pod`` × ``data``, pod
major: on a ``(2, 2, M)`` mesh rows 0–1 are pod 0's); :attr:`Mesh.rows`
lists each row's model-axis devices, which is how the train step and
the serving engines address the grid.

Devices may repeat — ``cuda:0`` four times is how four devices are
simulated on one card, ``cpu`` four times in the CPU tests (the
reference's ``--xla_force_host_platform_device_count``). The class is
the port's own: ``torch.distributed.DeviceMesh`` needs one process per
device and a process group, and the reference serves from a single
controller.

A *share* (:meth:`Mesh.share`) is one device's share of a mesh: the
same axes and sizes, every position of the grid naming the one device
the share runs on (``meta`` for a dry run, or a card), and
:attr:`Mesh.rows` one row of that one device. The one-controller mesh
program handed a share runs one coordinate's work: the data row and the
model shard of ``coord``, with every collective priced and replaced by
a stand-in of its output (:mod:`repro_torch.distributed.collectives`).

Building a mesh touches no device state beyond naming the devices, so
importing this module never initializes CUDA.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

#: every axis a mesh may have, in the order a mesh lists them
AXES = ("pod", "data", "model")
#: the data-parallel axes, in the order their rows flatten (pod major)
DATA_AXES = ("pod", "data")


def indexed_device(device) -> torch.device:
    """``cuda`` → ``cuda:<current>``: tensors report an indexed device,
    and the mesh's devices are compared with theirs."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _grid(devices, depth: int):
    """Nested sequences of devices → nested tuples of indexed devices,
    checked to be a non-empty rectangular grid of ``depth`` levels."""
    if depth == 0:
        return indexed_device(devices)
    if isinstance(devices, (str, torch.device)) or not len(devices):
        raise ValueError("mesh devices must form a non-empty grid with one "
                         "level per axis")
    out = tuple(_grid(d, depth - 1) for d in devices)
    if depth > 1 and any(_dims(o) != _dims(out[0]) for o in out):
        raise ValueError("mesh devices must form a rectangular grid")
    return out


def _dims(grid) -> Tuple[int, ...]:
    dims = []
    while isinstance(grid, tuple):
        dims.append(len(grid))
        grid = grid[0]
    return tuple(dims)


class Mesh:
    """A grid of devices over ``axis_names`` (an ordered subset of
    :data:`AXES`), row-major: ``devices`` is nested one level per axis,
    as the reference's ``jax.sharding.Mesh.devices`` array. ``shape``
    (a dict, axis name → size) reads as the reference's."""

    #: the coordinate a share (:meth:`share`) runs, axis → index; None
    #: for a whole mesh
    coord: Optional[Dict[str, int]] = None

    def __init__(self, devices: Sequence, axis_names=("data", "model")):
        names = tuple(axis_names)
        if not names or names != tuple(a for a in AXES if a in names) \
                or len(set(names)) != len(names):
            raise ValueError(f"mesh axes must be an ordered subset of "
                             f"{AXES}, got {names}")
        self.devices = _grid(devices, len(names))
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, _dims(self.devices)))

    def device(self, coord: Union[Sequence[int], Dict[str, int]]
               ) -> torch.device:
        """The device at ``coord``: one index per axis, or a dict of
        axis → index (axes it leaves out at 0)."""
        if isinstance(coord, dict):
            coord = [coord.get(a, 0) for a in self.axis_names]
        d = self.devices
        for i in coord:
            d = d[i]
        return d

    @property
    def first_device(self) -> torch.device:
        """The device at the origin, where a controller's results land."""
        return self.device([0] * len(self.axis_names))

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The mesh's data-parallel axes ('pod' folds into DP), in the
        order their rows flatten."""
        return tuple(a for a in DATA_AXES if a in self.axis_names)

    def row_coord(self, r: int) -> Dict[str, int]:
        """Data row ``r``'s index on each data axis (pod major)."""
        out = {}
        for a in reversed(self.data_axes):
            r, out[a] = divmod(r, self.shape[a])
        return out

    @functools.cached_property
    def rows(self) -> Tuple[Tuple[torch.device, ...], ...]:
        """Each data row's model-axis devices (a row of one device
        without a 'model' axis), rows flattened pod major."""
        if self.coord is not None:              # a share: its one device
            return ((self.first_device,),)
        n_rows = math.prod(self.shape[a] for a in self.data_axes)
        m = self.shape.get("model", 1)
        return tuple(
            tuple(self.device(dict(self.row_coord(r), model=j))
                  for j in range(m))
            for r in range(n_rows))

    def submesh(self, r: Union[int, Sequence[int]]) -> "Mesh":
        """Data row ``r`` — its flat index, or its ``(pod, data)``
        indices — as a mesh with the same axis names, each data axis of
        size 1 (one replica's tensor-parallel mesh)."""
        if not isinstance(r, int):
            idx = tuple(r)
            r = 0
            for a, i in zip(self.data_axes, idx):
                r = r * self.shape[a] + i
        row = self.rows[r]
        grid = row if "model" in self.axis_names else row[0]
        for _ in self.data_axes:
            grid = (grid,)
        return Mesh(grid, self.axis_names)

    def share(self, coord: Union[Sequence[int], Dict[str, int]] = (),
              device=None) -> "Mesh":
        """Device ``coord``'s share of this mesh (one index per axis, or
        a dict of axis → index, axes it leaves out at 0): a mesh of the
        same axes and sizes whose every position names ``device``
        (default the device at ``coord``), with ``coord`` set and
        :attr:`rows` one row of that one device. A model-axis leaf of a
        share keeps its logical shard index (``collectives.Shards``)."""
        if not isinstance(coord, dict):
            coord = dict(zip(self.axis_names, coord))
        coord = {a: int(coord.get(a, 0)) for a in self.axis_names}
        for a, i in coord.items():
            if not 0 <= i < self.shape[a]:
                raise ValueError(f"coordinate {coord} outside the mesh "
                                 f"{self.shape}")
        dev = (self.device(coord) if device is None
               else indexed_device(device))

        def fill(dims):
            return dev if not dims else [fill(dims[1:])
                                         for _ in range(dims[0])]

        out = Mesh(fill(tuple(self.shape.values())), self.axis_names)
        out.coord = coord
        return out

    @property
    def share_row(self) -> int:
        """A share's flat data row (pod major), 0 for a whole mesh."""
        if self.coord is None:
            return 0
        r = 0
        for a in self.data_axes:
            r = r * self.shape[a] + self.coord[a]
        return r

    def coords(self):
        """Every device coordinate, row-major."""
        return itertools.product(*(range(self.shape[a])
                                   for a in self.axis_names))

    @property
    def physical_devices(self) -> Tuple[torch.device, ...]:
        """The distinct devices of the grid, in order of first use."""
        return tuple(dict.fromkeys(self.device(c) for c in self.coords()))

    def __repr__(self) -> str:
        dims = "x".join(str(v) for v in self.shape.values())
        names = ", ".join(str(d) for d in self.physical_devices)
        if self.coord is not None:
            return (f"Mesh({dims} {self.axis_names}: the share of "
                    f"{self.coord} on {names})")
        return f"Mesh({dims} {self.axis_names} over {names})"


def _default_axes(n: int) -> Tuple[str, ...]:
    if n == 2:
        return ("data", "model")
    if n == 3:
        return AXES
    raise ValueError(f"a mesh of {n} sizes needs its axis names")


def _host_devices():
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int], axis_names=None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``shape`` mesh over ``axis_names`` (default ``("data",
    "model")`` for two sizes, ``("pod", "data", "model")`` for three)
    over the first prod(shape) of ``devices`` (default: every CUDA
    device of the host), row-major."""
    shape = tuple(shape)
    names = _default_axes(len(shape)) if axis_names is None \
        else tuple(axis_names)
    if len(names) != len(shape):
        raise ValueError(f"a mesh of shape {shape} over axes {names}")
    devices = list(_host_devices() if devices is None else devices)
    need = math.prod(shape)
    if min(shape) < 1 or len(devices) < need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {need} "
                         f"devices, got {len(devices)}")

    def nest(flat, dims):
        if not dims:
            return flat[0]
        per = len(flat) // dims[0]
        return [nest(flat[i * per:(i + 1) * per], dims[1:])
                for i in range(dims[0])]

    return Mesh(nest(devices[:need], shape), names)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The reference's production meshes: one pod of 16×16 = 256 devices
    over ``("data", "model")``, or 2 pods × 256 = 512 over ``("pod",
    "data", "model")`` (``data``: DP + ZeRO; ``model``: TP / experts /
    vocabulary; ``pod``: cross-pod DP, or the GPipe stages). Built over
    ``devices`` (default the host's CUDA devices); a host with fewer
    devices is refused, never padded."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    devices = list(_host_devices() if devices is None else devices)
    need = math.prod(shape)
    if len(devices) < need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production "
            f"mesh {'x'.join(map(str, shape))} needs {need} devices, the "
            f"host has {len(devices)}")
    return make_mesh(shape, _default_axes(len(shape)), devices)


def make_host_mesh(model_axis: int = 1, devices: Optional[Sequence] = None
                   ) -> Mesh:
    """A ``(n // model_axis, model_axis)`` mesh over the host's n
    devices (default every CUDA device; a list such as ``["cpu"] * 8``
    or ``["cuda:0"] * 4`` simulates n), as the reference's
    ``make_host_mesh`` spans ``jax.devices()``."""
    devices = list(_host_devices() if devices is None else devices)
    if model_axis < 1 or len(devices) < model_axis:
        raise ValueError(f"a model axis of {model_axis} over "
                         f"{len(devices)} devices")
    return make_mesh((len(devices) // model_axis, model_axis),
                     ("data", "model"), devices)

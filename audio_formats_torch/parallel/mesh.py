"""Device mesh and sharding helpers.

The unit of parallelism is the audio stream: a batch's lanes split over the
mesh's 'data' axis (pure data parallelism, the only kind this domain
rewards); the 'model' axis keeps the mesh 2-D and splits the channel axis of
carried per-channel state where channels are independent.

PyTorch has no SPMD partitioner, so a sharded tensor here is a grid of
pieces, one on each mesh device, and the code that runs on it runs once a
piece.  ``BatchDecoder(mesh=)`` and the batch encoders shard where lanes are
independent: each shard of a lockstep group is a group of its own on its
own device, with its own windows, pools and carried state, so no device
ever needs another's data and no collective runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def explicit_device(device) -> torch.device:
    """`device` as a torch.device with an explicit index for CUDA: "cuda"
    becomes ``cuda:<current>`` (a tensor made on plain "cuda" in a worker
    thread lands on that thread's current device, which is always 0).
    Raises when the CUDA device does not exist; there is no CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = torch.cuda.current_device() if count and dev.index is None \
            else dev.index
        if index is None or index >= count:
            raise RuntimeError(f"device {dev} requested but {count} CUDA "
                               "devices exist")
        dev = torch.device("cuda", index)
    return dev


def mesh_device(device, mesh) -> torch.device:
    """The device of an entry point called with `device` and `mesh`: the
    mesh's first device.  A `device` other than the default "cuda" that
    differs from it raises ValueError."""
    first = mesh.devices[0, 0]
    if device != "cuda" and explicit_device(device) != first:
        raise ValueError(f"device {device} differs from the mesh's first "
                         f"device {first}")
    return first


class Mesh:
    """A ('data', 'model') grid of torch devices.

    ``devices`` is a [data, model] numpy object array of torch.device, each
    with an explicit index; an entry may repeat (shards on one device run
    one after another).  ``shape`` maps each axis name to its size."""

    axis_names = ("data", "model")

    def __init__(self, devices: Sequence[Sequence]):
        rows = [[explicit_device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangular "
                             "[data][model] grid of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for d, row in enumerate(rows):
            for m, dev in enumerate(row):
                self.devices[d, m] = dev
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self):
        """The device of each 'data' shard: the first of its row."""
        return [self.devices[d, 0] for d in range(self.shape["data"])]

    def __repr__(self):
        return f"Mesh({self.shape}, {self.devices.tolist()})"


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') mesh over the first n_devices devices.

    With ``devices`` given, its entries in order (an entry may repeat: the
    CPU tests name "cpu" 8 times, a smoke run on one card "cuda:0" 4
    times).  Without it, ``cuda:0`` .. ``cuda:n-1``; raises where fewer
    CUDA devices exist.  ``data`` defaults to n_devices // model."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_devices or count
        if n < 1 or count < n:
            raise RuntimeError(f"make_mesh needs {max(n, 1)} CUDA devices "
                               f"but {count} exist")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = list(devices)
        n = n_devices or len(devs)
        if len(devs) < n:
            raise ValueError(f"make_mesh needs {n} devices but {len(devs)} "
                             "were given")
    data = data or (n // model)
    if data < 1 or model < 1 or data * model > len(devs):
        raise ValueError(f"a mesh of data {data} x model {model} does not "
                         f"fit {len(devs)} devices")
    return Mesh([devs[r * model:(r + 1) * model] for r in range(data)])


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A split plan: axis k of a tensor splits over the mesh axis
    ``spec[k]`` ("data", "model" or None: whole).  Pieces are contiguous and
    sized as ``np.array_split`` gives them, so an uneven count is fine; a
    tensor whose spec names no "model" axis is whole on each model
    column."""

    mesh: Mesh
    spec: tuple

    def split(self, x):
        """x (a tensor or numpy array) as a [data][model] grid of pieces,
        the piece at (d, m) on ``mesh.devices[d, m]``."""
        x = torch.as_tensor(x)
        D, M = self.mesh.devices.shape
        grid = []
        for d in range(D):
            row = []
            for m in range(M):
                piece = x
                for axis, name in enumerate(self.spec):
                    if name is not None:
                        k, n = (d, D) if name == "data" else (m, M)
                        piece = torch.tensor_split(piece, n, dim=axis)[k]
                row.append(piece.to(self.mesh.devices[d, m]))
            grid.append(row)
        return grid

    def gather(self, grid) -> torch.Tensor:
        """The inverse of ``split``: the pieces joined on the mesh's first
        device."""
        dev = self.mesh.devices[0, 0]

        def join(parts, name):
            if name not in self.spec:
                return parts[0]
            return torch.cat(parts, dim=self.spec.index(name))

        return join([join([p.to(dev) for p in row], "model")
                     for row in grid], "data")


def batch_sharding(mesh: Mesh) -> Sharding:
    """Split the leading stream-batch axis over 'data'."""
    return Sharding(mesh, ("data",))


def batch_channel_sharding(mesh: Mesh, ndim: int,
                           channel_axis: int = 2) -> Sharding:
    """Batch on 'data', the channel axis on 'model', the rest whole."""
    spec = [None] * ndim
    spec[0] = "data"
    if channel_axis < ndim:
        spec[channel_axis] = "model"
    return Sharding(mesh, tuple(spec))


def shard_batch(tree, mesh: Mesh):
    """Split every leaf's leading axis into ``mesh.shape["data"]``
    contiguous pieces, piece d on ``mesh.data_devices[d]``: each tensor or
    numpy leaf of the (dict, list, tuple) tree becomes a list of pieces."""
    plan = batch_sharding(mesh)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        if isinstance(x, (torch.Tensor, np.ndarray)):
            return [row[0] for row in plan.split(x)]
        return x

    return place(tree)

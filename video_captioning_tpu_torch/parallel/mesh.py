"""The ``(data, model)`` device mesh over ``torch.distributed``.

Counterpart of video_captioning_tpu/parallel/mesh.py. The JAX mesh lays
devices out on a grid and lets XLA insert the collectives; here each
process drives one device, the grid is over the process ranks
(row-major: rank = data_index * model + model_index), and each axis has the
process group of the ranks that differ only along it, which the port's
collectives name explicitly (``parallel/sharding.py``,
``parallel/context_parallel.py``). In one process without
``torch.distributed`` a mesh is a grid of devices with no groups: the
serving replicas of ``inference/predictor.py`` split a batch over its
``data`` devices, and every collective over an axis of size 1 is the
identity.

``set_mesh`` makes a mesh ambient for the code under it, as
``jax.sharding.set_mesh`` does for the JAX generation loops
(``parallel.context_axis`` reads it).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """A grid of positions, one axis per name of ``axis_names``:
    ``devices`` holds each position's rank under ``torch.distributed`` (one
    device a process), or its ``torch.device`` in a single process.
    ``rank`` is this process's position in row-major order (0 without
    ``torch.distributed``), ``coords`` its index along each axis, and
    ``group(axis)`` the process group of the ranks that differ only along
    ``axis`` (under ``torch.distributed`` every axis has one, of one rank
    where the axis has size 1; without it, None: no collective is made)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self.rank = dist.get_rank() if distributed() else 0
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, devices.shape))
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {n: None for n in self.axis_names}
        if distributed():
            ranks = np.arange(self.size).reshape(devices.shape)
            # Every rank creates every group, in the same order.
            for axis, name in enumerate(self.axis_names):
                lines = np.moveaxis(ranks, axis, -1).reshape(-1, devices.shape[axis])
                for line in lines:
                    group = dist.new_group([int(r) for r in line])
                    if self.rank in line:
                        self._groups[name] = group

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self._groups[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(config: Config, devices: Optional[Sequence] = None) -> Mesh:
    """Build the (data, model) mesh: over the ``torch.distributed`` ranks
    when a process group is up (every rank must be on the mesh), else over
    ``devices`` (default: the visible CUDA devices; with none visible it
    raises, so a CPU mesh is asked for by name, ``["cpu"]``; a string is a
    device name).
    ``parallel.data_axis == -1`` means all devices the model axis leaves."""
    if devices is None:
        if distributed():
            devices = list(range(dist.get_world_size()))
        elif torch.cuda.is_available():
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            raise RuntimeError("make_mesh: no CUDA device is visible and no torch.distributed "
                               "process group is up; pass devices=['cpu'] for a CPU mesh")
    devices = [torch.device(d) if isinstance(d, str) else d for d in devices]
    n = len(devices)
    model = max(1, config.parallel.model_axis)
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model_axis={model}")
    data = config.parallel.data_axis
    if data == -1:
        data = n // model
    needed = data * model
    if needed > n:
        raise ValueError(f"mesh {data}x{model} needs {needed} devices, have {n}")
    if distributed() and needed != dist.get_world_size():
        raise ValueError(f"mesh {data}x{model} must hold every one of the "
                         f"{dist.get_world_size()} torch.distributed ranks")
    # Explicit sizes may use a subset of the devices (one process).
    grid = np.empty(needed, dtype=object)
    grid[:] = devices[:needed]
    return Mesh(grid.reshape(data, model), config.parallel.axis_names)


def local_shard_info(mesh: Mesh) -> Tuple[int, int]:
    """(process rank, process count) for per-process input sharding."""
    if distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


_AMBIENT: list = []


@contextlib.contextmanager
def set_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Make ``mesh`` the ambient mesh of the block."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh() -> Optional[Mesh]:
    return _AMBIENT[-1] if _AMBIENT else None

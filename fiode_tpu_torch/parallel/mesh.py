"""Device meshes for sharded certification (counterpart of
``fiode_tpu/parallel/mesh.py``).

A ``Mesh`` is an array of ``torch.device``s with one name per axis.  The
``Certifier`` (``verify/certify.py``) splits its sweep by the JAX package's
placement rules: a 1-D mesh of any name splits the grid cells; a 2-D mesh
splits the images over its "img" axis and the cells over its "cell" axis.
Each shard runs on its own device and the per-image maximum is reduced on
the model's device.  A device may appear more than once (``[cpu] * 4``,
``[cuda:0] * 2``): its shards then run one after the other.

Training is data-parallel over processes instead (``parallel/multihost.py``):
the JAX package's batch sharding over a data mesh (``shard_batch``,
``replicate``, ``data_sharding``) has no counterpart here.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "make_mesh2d"]


class Mesh:
    """``devices``: a (nested) sequence of devices or device strings, one
    array axis per name in ``axis_names``; "cuda" without an index is the
    current CUDA device."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.array(devices, dtype=object)
        flat = [_indexed(torch.device(d)) for d in arr.reshape(-1)]
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or not flat:
            raise ValueError(f"a mesh of shape {self.devices.shape} needs one "
                             f"name per axis, got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size


def _indexed(d: torch.device) -> torch.device:
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _devices(n: int, device_type: str):
    if device_type == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    if n > count:
        raise RuntimeError(f"a mesh of {n} {device_type} devices needs {n}; "
                           f"{count} found")
    return [torch.device(device_type, i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device_type: str = "cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` CUDA devices (all of them by
    default); raises if fewer exist.  ``device_type="cpu"`` repeats the CPU
    ``n_devices`` times (default 1)."""
    if n_devices is None:
        n_devices = torch.cuda.device_count() if device_type == "cuda" else 1
        if n_devices == 0:
            raise RuntimeError("make_mesh: no CUDA device found")
    return Mesh(_devices(int(n_devices), device_type), (axis,))


def make_mesh2d(n_img: int, n_cell: int, axes: tuple = ("img", "cell"),
                device_type: str = "cuda") -> Mesh:
    """A 2-D mesh for certification sweeps: images over the first axis,
    grid cells over the second (innermost, so a per-image max reduces over
    neighbouring devices)."""
    devs = _devices(n_img * n_cell, device_type)
    return Mesh(np.array(devs, dtype=object).reshape(n_img, n_cell), axes)

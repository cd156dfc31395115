"""Mesh definitions: port of ``repro/launch/mesh.py``.

Two kinds of mesh:

* :class:`LogicalMesh`, axis names and sizes with no devices: the
  production meshes of the dry-run (``launch.cell``, ``launch.dryrun``),
  which read nothing else of a mesh (a 256-device mesh needs no cards to
  be sized);
* :class:`DeviceMesh`, the runtime mesh of multi-device training: names,
  sizes and a grid of ``torch.device``s driven from one process, as the
  reference's single-controller ``Mesh`` is.  A device may repeat:
  ``make_local_mesh(2, 2)`` with ``REPRO_TORCH_MESH_DEVICES=4`` is four
  shards of one card (or of the CPU in the tests).  A named axis at fixed
  other coordinates is a 1-D ``distributed.collectives.Mesh``
  (:meth:`DeviceMesh.group`), over which the collectives run.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.collectives import Mesh, make_mesh


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Axis names and sizes, as ``jax.sharding.AbstractMesh`` holds them."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


@dataclasses.dataclass(frozen=True)
class DeviceMesh(LogicalMesh):
    """A named mesh of devices, ``devices`` in row-major order over the
    axes (the last axis fastest), as ``np.array(devices).reshape(sizes)``
    lays out the reference's."""

    devices: tuple[torch.device, ...] = ()

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        if len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of shape {self.shape}")

    def index(self, **coords: int) -> int:
        """The flat index of the device at ``coords`` (an axis left out is 0)."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no axes {sorted(unknown)} in mesh {self.axis_names}")
        i = 0
        for name, size in zip(self.axis_names, self.axis_sizes):
            c = coords.get(name, 0)
            if not 0 <= c < size:
                raise ValueError(f"coordinate {name}={c} outside [0, {size})")
            i = i * size + c
        return i

    def device(self, **coords: int) -> torch.device:
        return self.devices[self.index(**coords)]

    def group(self, axis: str, **coords: int) -> Mesh:
        """The 1-D mesh along ``axis`` with the other axes at ``coords``."""
        return Mesh(tuple(self.device(**{**coords, axis: r})
                          for r in range(self.shape[axis])))


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1,
                    device: str | torch.device = "cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over the first ``data * model`` devices that
    ``repro_torch.device.mesh_devices`` gives (every card, or the visible
    ones repeated under ``REPRO_TORCH_MESH_DEVICES``); raises, as
    ``collectives.make_mesh`` does, when fewer are visible."""
    flat = make_mesh(data * model, device)
    return DeviceMesh((data, model), ("data", "model"), flat.devices)


def mesh_dp_size(mesh) -> int:
    size = 1
    for ax in ("pod", "data"):
        if ax in mesh.axis_names:
            size *= mesh.shape[ax]
    return size


def mesh_tp_size(mesh) -> int:
    return mesh.shape.get("model", 1)

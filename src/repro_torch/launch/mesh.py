"""Production mesh definitions: port of ``repro/launch/mesh.py``.

A mesh here is logical: axis names and sizes, no devices.  The dry-run
(``launch.cell``, ``launch.dryrun``) reads nothing else of it, and a
``torch.distributed.DeviceMesh`` of 256 devices would need a process
group of 256 ranks.  The runtime mesh of multi-device training comes with
slice 2b (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import math


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


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes)


def mesh_dp_size(mesh) -> int:
    size = 1
    for ax in ("pod", "data"):
        if ax in mesh.axis_names:
            size *= mesh.shape[ax]
    return size


def mesh_tp_size(mesh) -> int:
    return mesh.shape.get("model", 1)

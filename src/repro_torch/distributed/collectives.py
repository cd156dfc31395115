"""The single-controller mesh's 1-D groups and their collectives.

The reference is single-controller: one process drives a ``Mesh`` of
devices through ``shard_map``.  The port does the same without
``torch.distributed``: a :class:`Mesh` is a tuple of ``torch.device``s
driven from one process, and a device may appear more than once
(``Mesh((cuda:0,) * 4)`` is four shards on one card; ``Mesh((cpu,) * 8)``
stands for the reference tests' 8 forced host devices).  A sharded array
is a list of per-shard tensors, entry r on ``mesh.devices[r]``.  A named
axis of a 2-D mesh (``launch.mesh.DeviceMesh.group``) is such a 1-D mesh.

The collectives are copies between the shards' devices: :func:`psum` and
:func:`pmax` (every rank gets the reduction, taken in rank order, so each
rank holds the same bits), :func:`all_gather`, :func:`ppermute` and the
ring :func:`ring_permute`.  Every copy is ``non_blocking`` and nothing here
reads a value back to the host, so the host issues one shard's work after
another and separate cards run it at once.

:func:`broadcast` and :func:`reduce_sum` are the tensor-parallel pair of
the model axis, differentiable (each is the other's transpose).
``COPIED_BYTES`` counts the bytes that those two and :func:`count_bytes`
move between shards, forward and backward: logical bytes, counted whether
or not the two shards share a card (on one card ``.to`` the same device
copies nothing).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import torch

from repro_torch.device import MESH_DEVICES_ENV, forced_mesh_size, mesh_devices, resolve_device

# bytes moved between shards by broadcast / reduce_sum / count_bytes since
# the last reset (a host int: tensor sizes are host metadata); backward
# hooks add to it from autograd's device threads
COPIED_BYTES = {"bytes": 0}
_COPIED_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh driven from one process; rank r is ``devices[r]``."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n: int, device: str | torch.device = "cuda") -> Mesh:
    """A mesh of the first ``n`` cards (raises if fewer are visible, as
    ``jax.make_mesh`` does), or of ``n`` CPU shards for ``device="cpu"``
    (the counterpart of forced host devices).  With
    ``REPRO_TORCH_MESH_DEVICES=S`` set, the first ``n`` of the S devices
    that :func:`repro_torch.device.mesh_devices` repeats, on either device
    type: ``make_mesh(4)`` is ``Mesh((cuda:0,) * 4)`` on one card."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"a mesh needs n >= 1 devices, got {n}")
    if dev.type == "cpu" and forced_mesh_size() is None:
        return Mesh((dev,) * n)
    visible = mesh_devices(dev)
    if n > len(visible):
        unit = "cards" if dev.type == "cuda" else "CPU devices"
        raise ValueError(f"a mesh of {n} devices needs {n} {unit}, but {len(visible)} "
                         f"are visible (set {MESH_DEVICES_ENV}={n} to repeat them)")
    return Mesh(visible[:n])


def same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` are one card when card 0 is the current one."""
    def norm(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


def shard_rows(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """Split x [N, ...] into ``mesh.size`` equal row blocks, block r on rank r."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"N={n} not divisible by {mesh.size} shards")
    n_loc = n // mesh.size
    return [x[r * n_loc:(r + 1) * n_loc].to(dev, non_blocking=True).contiguous()
            for r, dev in enumerate(mesh.devices)]


def gather_rows(parts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The rows of every shard in rank order on one device (default: rank 0's)."""
    dev = parts[0].device if device is None else torch.device(device)
    return torch.cat([p.to(dev, non_blocking=True) for p in parts])


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Every rank gets all shards' rows in rank order (``all_gather(tiled=True)``)."""
    return [gather_rows(parts, dev) for dev in mesh.devices]


def psum(mesh: Mesh, values: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Every rank gets the sum of all ranks' values, added in rank order, so
    each rank holds the same bits."""
    out = []
    for dev in mesh.devices:
        total = values[0].to(dev, non_blocking=True)
        for v in values[1:]:
            total = total + v.to(dev, non_blocking=True)
        out.append(total)
    return out


def pmax(mesh: Mesh, values: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Every rank gets the elementwise maximum of all ranks' values."""
    out = []
    for dev in mesh.devices:
        top = values[0].to(dev, non_blocking=True)
        for v in values[1:]:
            top = torch.maximum(top, v.to(dev, non_blocking=True))
        out.append(top)
    return out


def ppermute(mesh: Mesh, parts: Sequence[torch.Tensor | None],
             perm: Sequence[tuple[int, int]]) -> list[torch.Tensor | None]:
    """``lax.ppermute``: for each pair (i, j), rank j receives rank i's
    tensor; a rank that no pair names receives None (the reference's
    zeros, which its callers mask)."""
    out: list[torch.Tensor | None] = [None] * mesh.size
    for i, j in perm:
        if parts[i] is not None:
            out[j] = parts[i].to(mesh.devices[j], non_blocking=True)
    return out


def ring_permute(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """One ring hop (``ppermute`` with pairs (i, i + 1)): rank r receives
    rank r - 1's tensor."""
    s = mesh.size
    return [parts[(r - 1) % s].to(dev, non_blocking=True) for r, dev in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# the model axis's differentiable pair
# ---------------------------------------------------------------------------

def count_bytes(nbytes: int) -> None:
    with _COPIED_LOCK:
        COPIED_BYTES["bytes"] += nbytes


def count_copy(t: torch.Tensor) -> None:
    """Add a copy of ``t`` to :data:`COPIED_BYTES`."""
    count_bytes(t.numel() * t.element_size())


def _count_grad(t: torch.Tensor) -> None:
    """Count the gradient of ``t`` when the backward sends it across."""
    if t.requires_grad:
        t.register_hook(lambda g: count_copy(g) or g)


def broadcast(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """x (on rank 0's device) on every rank's device; its gradient is the
    rank-order sum of theirs (autograd's copy back and accumulation)."""
    out = [x.to(mesh.devices[0], non_blocking=True)]
    for dev in mesh.devices[1:]:
        y = x.to(dev, non_blocking=True)
        count_copy(y)
        _count_grad(y)
        out.append(y)
    return out


def reduce_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The psum of the model axis's partial results, read on ``device``
    (rank 0's): added in rank order.  Each part's gradient is the sum's,
    copied to the part's device."""
    total = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        count_copy(p)
        _count_grad(p)
        total = total + p.to(device, non_blocking=True)
    return total

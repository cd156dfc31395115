"""Sharded neighbor backend, the distributed KNN rings behind the registry:
port of ``repro/neighbors/sharded.py``.

``ShardedNeighbors`` puts both rings of ``core/distributed.py`` behind
the standard ``neighbors(x, k)`` contract:

* ``mode="approx"`` (default): per-shard rp_forest and the candidate ring
  (:func:`repro_torch.core.distributed.ring_knn_approx`); peak memory is
  bounded by ``block_rows``, not N;
* ``mode="exact"``: the exact ring (:func:`repro_torch.core.distributed.ring_knn`),
  the recall oracle.

``shards=None`` uses every visible device (:func:`visible_devices`: all
cards for a CUDA input, one CPU for a CPU input, where the ring
degenerates to one local forest pass, still row-blocked;
``REPRO_TORCH_MESH_DEVICES=S`` makes it S, as forced host devices do for
the reference).  Inputs of any
N are zero-padded to a shard multiple; pad rows are masked out of every
merge and cut from the result.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch.device import MESH_DEVICES_ENV, mesh_devices
from repro_torch.neighbors.base import register_neighbor_backend, validate_k

MODES = ("approx", "exact")


def visible_devices(device: torch.device) -> tuple[torch.device, ...]:
    """The devices a mesh for data on ``device`` may use
    (:func:`repro_torch.device.mesh_devices`, which honours the forced mesh size)."""
    return mesh_devices(device)


@dataclasses.dataclass(frozen=True)
class ShardedNeighbors:
    """Distributed KNN over a 1-D device mesh (see module docstring).

    shards     : device count (None = all visible devices, clamped so each
                 shard keeps > k points)
    mode       : "approx" (rp_forest candidate ring) | "exact" (oracle ring)
    n_trees    : forest width per shard (approx mode)
    leaf_size  : leaf occupancy floor per tree (approx mode); the candidate
                 set per hop is n_trees * max(leaf_size, k+1)-ish columns
    block_rows : rows per routing/scoring/merge slice, the memory knob
    seed       : rank r's forest draws from seed + r * 7919
    axis       : the reference's mesh axis name, kept so a JAX config
                 carries across; a port mesh has one unnamed axis
    """

    name: ClassVar[str] = "sharded"
    shards: int | None = None
    mode: str = "approx"
    n_trees: int = 8
    leaf_size: int = 64
    block_rows: int = 4096
    seed: int = 0
    axis: str = "knn"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"unknown sharded mode {self.mode!r} (known: {', '.join(MODES)})"
            )

    def resolve_shards(self, n: int, k: int, device: torch.device) -> int:
        """Devices actually used for data on ``device``: requested (or all
        visible), bounded by what keeps every shard larger than k+1 points."""
        avail = len(visible_devices(device))
        s = avail if self.shards in (None, 0) else int(self.shards)
        if s > avail:
            raise ValueError(f"shards={s} but only {avail} device(s) are visible for "
                             f"{torch.device(device).type} data; set {MESH_DEVICES_ENV}={s} "
                             "or lower shards")
        return max(1, min(s, n // (k + 2)))

    def neighbors(self, x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        from repro_torch.core.distributed import (
            Mesh, gather_rows, ring_knn, ring_knn_approx, shard_rows,
        )

        n = int(x.shape[0])
        validate_k(n, k)
        s = self.resolve_shards(n, k, x.device)
        mesh = Mesh(visible_devices(x.device)[:s])
        xp = torch.nn.functional.pad(x, (0, 0, 0, (-n) % s))
        parts = shard_rows(mesh, xp)
        if self.mode == "exact":
            idx, d2 = ring_knn(mesh, parts, k, n_valid=n)
        else:
            idx, d2 = ring_knn_approx(mesh, parts, k, n_valid=n, n_trees=self.n_trees,
                                      leaf_size=self.leaf_size, block_rows=self.block_rows,
                                      seed=self.seed)
        return gather_rows(idx, x.device)[:n], gather_rows(d2, x.device)[:n]


register_neighbor_backend("sharded", ShardedNeighbors)

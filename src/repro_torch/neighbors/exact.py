"""Exact neighbor backend, the blocked brute force of ``core/knn.py``:
port of ``repro/neighbors/exact.py::ExactNeighbors.neighbors``.

Every distance tile goes through the ``pairwise_sq_dists`` kernel on the
card (its plain twin on the CPU); recall 1.0 by construction.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch.core.knn import knn
from repro_torch.neighbors.base import register_neighbor_backend, validate_k


@dataclasses.dataclass(frozen=True)
class ExactNeighbors:
    """Blocked brute-force KNN (paper §3.1)."""

    name: ClassVar[str] = "exact"
    block_q: int = 512
    block_db: int = 2048

    def neighbors(self, x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        validate_k(x.shape[0], k)
        return knn(x, k, block_q=self.block_q, block_db=self.block_db)


register_neighbor_backend("exact", ExactNeighbors)

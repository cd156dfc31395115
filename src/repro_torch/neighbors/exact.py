"""Exact neighbor backend, the blocked brute force of ``core/knn.py``:
port of ``repro/neighbors/exact.py``.

Every distance tile goes through the ``pairwise_sq_dists`` kernel on the
card (its plain twin on the CPU); recall 1.0 by construction.  The query
index is the same blocked scan with query rows in place of the database
rows, so out-of-sample points get recall 1.0 too.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch.core.knn import knn, knn_query
from repro_torch.neighbors.base import (
    register_neighbor_backend, validate_k, validate_query_k,
)


@dataclasses.dataclass(frozen=True, eq=False)
class ExactIndex:
    """Brute-force query index: holds the reference points verbatim."""

    x_ref: torch.Tensor
    block_q: int = 512
    block_db: int = 2048

    @property
    def n_reference(self) -> int:
        return int(self.x_ref.shape[0])

    def query(self, x_new: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        validate_query_k(self.n_reference, k)
        return knn_query(x_new.to(self.x_ref.dtype), self.x_ref, k,
                         block_q=self.block_q, block_db=self.block_db)


@dataclasses.dataclass(frozen=True)
class ExactNeighbors:
    """Blocked brute-force KNN (paper §3.1)."""

    name: ClassVar[str] = "exact"
    block_q: int = 512
    block_db: int = 2048

    def neighbors(self, x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        validate_k(x.shape[0], k)
        return knn(x, k, block_q=self.block_q, block_db=self.block_db)

    def build_index(self, x: torch.Tensor) -> ExactIndex:
        return ExactIndex(x_ref=x, block_q=self.block_q, block_db=self.block_db)


register_neighbor_backend("exact", ExactNeighbors)

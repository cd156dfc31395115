"""Pluggable K-nearest-neighbor backends (paper §3.1): port of ``repro.neighbors``.

Only ``exact`` is ported so far.
"""
from repro_torch.neighbors.base import (
    NeighborBackend, available_neighbor_backends, make_neighbor_backend,
    recall_at_k, register_neighbor_backend, unregister_neighbor_backend,
    validate_k,
)
from repro_torch.neighbors.exact import ExactNeighbors

__all__ = [
    "NeighborBackend", "ExactNeighbors", "register_neighbor_backend",
    "unregister_neighbor_backend", "available_neighbor_backends",
    "make_neighbor_backend", "validate_k", "recall_at_k",
]

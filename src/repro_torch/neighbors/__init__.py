"""Pluggable K-nearest-neighbor backends (paper §3.1): port of ``repro.neighbors``.

    from repro_torch.neighbors import make_neighbor_backend
    idx, d2 = make_neighbor_backend("rp_forest").neighbors(x, k)

Backends ("exact" | "rp_forest" | "nn_descent", or your own via
:func:`register_neighbor_backend`) plug in behind ``preprocess`` /
``TSNE(neighbor_method=...)``.  The reference's "sharded" backend comes
with the multi-device port.
"""
from repro_torch.neighbors.base import (
    NeighborBackend, NeighborIndex, available_neighbor_backends, build_query_index,
    make_neighbor_backend, recall_at_k, register_neighbor_backend,
    unregister_neighbor_backend, validate_k, validate_query_k,
)
from repro_torch.neighbors.exact import ExactIndex, ExactNeighbors
from repro_torch.neighbors.rp_forest import (
    RPForestIndex, RPForestNeighbors, forest_query, rp_forest_knn,
)
from repro_torch.neighbors.nn_descent import NNDescentNeighbors, nn_descent_knn
from repro_torch.neighbors._candidates import merge_topk, seed_graph

__all__ = [
    "NeighborBackend", "NeighborIndex",
    "ExactNeighbors", "RPForestNeighbors", "NNDescentNeighbors",
    "ExactIndex", "RPForestIndex",
    "register_neighbor_backend", "unregister_neighbor_backend",
    "available_neighbor_backends", "make_neighbor_backend", "validate_k",
    "validate_query_k", "build_query_index",
    "recall_at_k", "rp_forest_knn", "nn_descent_knn", "forest_query",
    "merge_topk", "seed_graph",
]

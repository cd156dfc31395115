"""Neighbor-backend protocol + string-keyed registry: port of ``repro/neighbors/base.py``.

A neighbor backend owns step 1 of the pipeline (paper §3.1): given the
input points it returns the K-nearest-neighbor graph ``(idx [N, K] int32,
d2 [N, K])`` that the perplexity search and symmetrization consume.
The estimator's ``neighbor_method=`` and ``TsneConfig.neighbor_method``
both dispatch through :func:`make_neighbor_backend`.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class NeighborBackend(Protocol):
    """``neighbors(x, k)`` maps points ``x [N, D]`` to ``(idx [N, k] int32,
    d2 [N, k])``: k distinct neighbors of each row point (self excluded)
    with their squared euclidean distances, on ``x``'s device.

    Backends that answer out-of-sample queries also implement
    ``build_index(x) -> NeighborIndex`` (see :func:`build_query_index`).
    """

    name: str

    def neighbors(self, x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        ...


@runtime_checkable
class NeighborIndex(Protocol):
    """A fitted reference set that answers out-of-sample KNN queries.

    ``query(x_new, k)`` maps query points ``x_new [M, D]`` (not members of
    the reference set) to ``(idx [M, k] int32, d2 [M, k])``: reference-set
    indices of the k nearest fitted points of each query, ascending by
    distance, with exact squared distances.  There is no self-exclusion.
    ``n_reference`` is the fitted set's size.
    """

    n_reference: int

    def query(self, x_new: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        ...


def build_query_index(backend: NeighborBackend, x: torch.Tensor) -> NeighborIndex:
    """Fit ``backend``'s query index over reference points ``x``.

    Backends without a ``build_index`` method (custom registrations, for
    example) fall back to the exact blocked scan.
    """
    builder = getattr(backend, "build_index", None)
    if builder is not None:
        return builder(x)
    from repro_torch.neighbors.exact import ExactNeighbors  # lazy: exact builds on base
    return ExactNeighbors().build_index(x)


def validate_query_k(n_reference: int, k: int) -> None:
    """Query (n, k) precondition: 1 <= k <= reference-set size."""
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    if k > n_reference:
        raise ValueError(f"k={k} must be <= reference-set size n={n_reference}")


def recall_at_k(ref_idx, idx) -> float:
    """Mean fraction of the reference k-neighbors recovered (host-side).

    Requires each row of both arrays to hold distinct indices, so per row
    ``|ref ∩ approx| = 2k - #unique(ref ++ approx)``.
    """
    ref_idx = np.asarray(ref_idx)
    idx = np.asarray(idx)
    both = np.sort(np.concatenate([ref_idx, idx], axis=1), axis=1)
    n_dup = (both[:, 1:] == both[:, :-1]).sum(axis=1)
    return float(n_dup.mean() / ref_idx.shape[1])


def validate_k(n: int, k: int) -> None:
    """Shared (n, k) precondition: at least one non-self neighbor per row."""
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    if k >= n:
        raise ValueError(f"k={k} must be < n={n}")


# factory(**options) -> NeighborBackend; dataclass constructors qualify
NeighborFactory = Callable[..., NeighborBackend]

_REGISTRY: dict[str, NeighborFactory] = {}


def register_neighbor_backend(name: str, factory: NeighborFactory | None = None):
    """Register a neighbor-backend factory under ``name`` (directly or as a
    decorator)."""
    def _register(fn: NeighborFactory) -> NeighborFactory:
        _REGISTRY[name] = fn
        return fn

    return _register(factory) if factory is not None else _register


def unregister_neighbor_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def available_neighbor_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_neighbor_backend(method: str,
                          options: Mapping[str, Any] | None = None) -> NeighborBackend:
    """Instantiate the backend registered under ``method`` with ``options``."""
    try:
        factory = _REGISTRY[method]
    except KeyError:
        raise ValueError(
            f"unknown neighbor method {method!r}; registered backends: "
            f"{', '.join(available_neighbor_backends())}"
        ) from None
    return factory(**dict(options or {}))

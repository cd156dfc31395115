"""Pluggable t-SNE gradient backends + string-keyed registry: port of
``repro/api/backends.py``:

* ``exact``       -- the O(N^2) oracle (``core/exact.py``)
* ``barnes_hut``  -- the paper's Morton/quadtree/summarize/traverse pipeline
* ``fft``         -- FIt-SNE-style grid-interpolation repulsion
                     (``core/fft_repulsion.py``, Linderman et al.)

A backend owns steps 3-6 of the pipeline: given the current embedding, the
:class:`~repro_torch.core.tsne.NeighborGraph` and the exaggeration factor,
it returns a :class:`~repro_torch.core.tsne.GradResult`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Protocol, runtime_checkable

import torch

from repro_torch.core import attractive, exact
from repro_torch.core.fft_repulsion import fft_repulsion
from repro_torch.core.tsne import (
    DEFAULT_ATTRACTIVE_IMPL, GradResult, NeighborGraph, TsneConfig, bh_gradient,
    combine_forces,
)


@runtime_checkable
class GradientBackend(Protocol):
    """What ``tsne_step`` needs from a backend."""

    name: str

    def gradient(self, y: torch.Tensor, graph: NeighborGraph,
                 exaggeration) -> GradResult:
        ...


def _check_ell_rows(graph: NeighborGraph, n: int, who: str) -> None:
    if graph.p_cols.shape[0] != n:
        raise ValueError(
            f"{who} needs the ELL rows, but this NeighborGraph was "
            "preprocessed edges-only (attractive_impl='edges')"
        )


def _check_attractive_layout(graph: NeighborGraph, n: int, attractive_impl: str) -> None:
    if attractive_impl == "edges":
        if not graph.has_edges:
            raise ValueError(
                "attractive_impl='edges' but the NeighborGraph carries no "
                "edge list; preprocess with TsneConfig(attractive_impl='edges')"
            )
    else:
        _check_ell_rows(graph, n, f"attractive_impl={attractive_impl!r}")


def _attractive(y, graph: NeighborGraph, attractive_impl: str):
    """Shared attractive-term dispatch (exaggeration-free; callers scale it)."""
    _check_attractive_layout(graph, y.shape[0], attractive_impl)
    if attractive_impl == "edges":
        return attractive.attractive_forces_edges(y, *graph.edges)
    return attractive.ell_forces(attractive_impl)(y, graph.p_cols, graph.p_vals,
                                                  graph.p_len)


@dataclasses.dataclass(frozen=True)
class ExactBackend:
    """O(N^2) dense gradient: the correctness oracle, feasible to ~5k points."""

    name: ClassVar[str] = "exact"

    def gradient(self, y, graph: NeighborGraph, exaggeration) -> GradResult:
        n = y.shape[0]
        _check_ell_rows(graph, n, "the exact backend")
        rows = torch.arange(n, device=y.device)[:, None].expand_as(graph.p_cols)
        # densify the ELL rows; padding entries carry val 0 on the diagonal
        p_dense = torch.zeros((n, n), dtype=y.dtype, device=y.device)
        p_dense.index_put_((rows, graph.p_cols.long()), graph.p_vals, accumulate=True)
        f_attr, kl_attr = exact.exact_attraction(y, p_dense)
        f_rep, z = exact.exact_repulsion(y)
        return combine_forces(f_attr, kl_attr, f_rep, z, exaggeration, graph.p_logp)


@dataclasses.dataclass(frozen=True)
class BarnesHutBackend:
    """The paper's pipeline: Morton encode -> quadtree -> summarize -> traverse."""

    name: ClassVar[str] = "barnes_hut"
    theta: float = 0.5
    depth: int = 16
    compress_tree: bool = True
    attractive_impl: str = DEFAULT_ATTRACTIVE_IMPL

    def gradient(self, y, graph: NeighborGraph, exaggeration) -> GradResult:
        _check_attractive_layout(graph, y.shape[0], self.attractive_impl)
        edges = graph.edges if self.attractive_impl == "edges" else None
        return bh_gradient(
            y, graph.p_cols, graph.p_vals, edges, self.theta, exaggeration,
            self.depth, graph.p_logp, compress_tree=self.compress_tree,
            attractive_impl=self.attractive_impl, p_len=graph.p_len,
        )


@dataclasses.dataclass(frozen=True)
class FFTBackend:
    """FIt-SNE-style repulsion: interpolate to a grid, convolve via FFT.

    The tensor's device picks the CUDA spread/gather kernels or their plain
    versions.
    """

    name: ClassVar[str] = "fft"
    n_boxes: int = 48
    attractive_impl: str = DEFAULT_ATTRACTIVE_IMPL

    def gradient(self, y, graph: NeighborGraph, exaggeration) -> GradResult:
        f_attr, kl_attr = _attractive(y, graph, self.attractive_impl)
        f_rep_unnorm, z = fft_repulsion(y, n_boxes=self.n_boxes)
        return combine_forces(f_attr, kl_attr, f_rep_unnorm, z, exaggeration,
                              graph.p_logp)


# factory(config, n_points) -> GradientBackend
BackendFactory = Callable[[TsneConfig, int], GradientBackend]

_REGISTRY: dict[str, BackendFactory] = {}


def register_backend(name: str, factory: BackendFactory | None = None):
    """Register a backend factory under ``name`` (directly or as a decorator)."""
    def _register(fn: BackendFactory) -> BackendFactory:
        _REGISTRY[name] = fn
        return fn

    return _register(factory) if factory is not None else _register


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_backend(method: str, config: TsneConfig, n: int) -> GradientBackend:
    """Instantiate the backend registered under ``method`` for an N-point run."""
    try:
        factory = _REGISTRY[method]
    except KeyError:
        raise ValueError(
            f"unknown t-SNE method {method!r}; registered backends: "
            f"{', '.join(available_backends())}"
        ) from None
    return factory(config, n)


@register_backend("exact")
def _make_exact(config: TsneConfig, n: int) -> ExactBackend:
    return ExactBackend()


@register_backend("barnes_hut")
def _make_barnes_hut(config: TsneConfig, n: int) -> BarnesHutBackend:
    return BarnesHutBackend(
        theta=config.theta,
        depth=config.resolve_depth(n),
        compress_tree=config.compress_tree,
        attractive_impl=config.attractive_impl,
    )


@register_backend("fft")
def _make_fft(config: TsneConfig, n: int) -> FFTBackend:
    return FFTBackend(n_boxes=config.fft_n_boxes,
                      attractive_impl=config.attractive_impl)

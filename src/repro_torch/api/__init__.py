"""Public t-SNE surface of the port: the estimator + backend registry.

    from repro_torch.api import TSNE
    emb = TSNE(method="barnes_hut", perplexity=30).fit_transform(x)   # on cuda
"""
from repro_torch.core.tsne import (
    GradResult, IterationStats, NeighborGraph, ObserverFn, TsneConfig,
    TsneResult, preprocess, run_tsne,
)
from repro_torch.api.backends import (
    BarnesHutBackend, ExactBackend, GradientBackend, available_backends,
    make_backend, register_backend, unregister_backend,
)
from repro_torch.api.estimator import TSNE
from repro_torch.neighbors import (
    NeighborBackend, available_neighbor_backends, make_neighbor_backend,
    register_neighbor_backend, unregister_neighbor_backend,
)

__all__ = [
    "TSNE",
    "GradientBackend", "ExactBackend", "BarnesHutBackend",
    "register_backend", "unregister_backend", "available_backends",
    "make_backend",
    "NeighborBackend", "register_neighbor_backend",
    "unregister_neighbor_backend", "available_neighbor_backends",
    "make_neighbor_backend",
    "GradResult", "IterationStats", "NeighborGraph", "ObserverFn",
    "TsneConfig", "TsneResult", "preprocess", "run_tsne",
]

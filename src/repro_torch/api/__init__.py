"""Public t-SNE surface of the port: the estimator + backend registry.

    from repro_torch.api import TSNE
    est = TSNE(method="barnes_hut", perplexity=30)    # on cuda
    emb = est.fit_transform(x)
    y_new = est.transform(x_new)                        # new points, no refit
    emb = TSNE(method="fft", device="cpu").fit_transform(x)   # FIt-SNE, CPU
    est = TSNE(trace="fit_trace.json").fit(x)           # spans: est.tracer_
"""
from repro_torch.core.tsne import (
    GradResult, IterationStats, NeighborGraph, ObserverFn, TsneConfig,
    TsneResult, preprocess, run_tsne,
)
from repro_torch.api.backends import (
    BarnesHutBackend, ExactBackend, FFTBackend, GradientBackend,
    available_backends, make_backend, register_backend, unregister_backend,
)
from repro_torch.api.estimator import TSNE
from repro_torch.neighbors import (
    NeighborBackend, NeighborIndex, available_neighbor_backends, build_query_index,
    make_neighbor_backend, register_neighbor_backend, unregister_neighbor_backend,
)
from repro_torch.embed import EmbeddingService, TransformConfig, TransformRequest
from repro_torch.obs import MetricsRegistry, RecompileProbe, Tracer

__all__ = [
    "TSNE",
    "GradientBackend", "ExactBackend", "BarnesHutBackend", "FFTBackend",
    "register_backend", "unregister_backend", "available_backends",
    "make_backend",
    "NeighborBackend", "NeighborIndex", "register_neighbor_backend",
    "unregister_neighbor_backend", "available_neighbor_backends",
    "make_neighbor_backend", "build_query_index",
    "EmbeddingService", "TransformConfig", "TransformRequest",
    "MetricsRegistry", "RecompileProbe", "Tracer",
    "GradResult", "IterationStats", "NeighborGraph", "ObserverFn",
    "TsneConfig", "TsneResult", "preprocess", "run_tsne",
]

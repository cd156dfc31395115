"""PyTorch / CUDA port of the Barnes-Hut t-SNE package ``repro``.

The layout mirrors ``repro``: ``core/`` (KNN, perplexity search,
symmetrization, Morton/quadtree/summaries/traversal, forces, descent loop),
``kernels/`` (hand-written CUDA kernels for Hopper and their registry),
``neighbors/``, ``embed/`` (transform and the embedding service),
``obs/`` (spans, metrics, probes), ``api/``, ``launch/`` and ``data/``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; a CUDA tensor always goes
through the CUDA kernel and a CPU tensor through its plain PyTorch twin.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

"""Out-of-sample embedding subsystem: port of ``repro.embed``
(``TSNE.transform`` and the serving loop).

Two layers over a frozen fitted embedding:

* :mod:`repro_torch.embed.transform`: the attractive-only descent that
  places new points among their k nearest *fitted* neighbors (one
  fixed-shape step; batch driver with padding and per-point early stop);
* :mod:`repro_torch.embed.service`: :class:`EmbeddingService`, the
  continuous-batching slot loop that drains a queue of single-point
  transform requests against a per-dataset cache of fitted models, with
  per-request latency/step stats.
"""
from repro_torch.embed.transform import (
    TransformConfig, TransformState, TransformStats, prepare_batch,
    transform_batch, transform_step,
)
from repro_torch.embed.service import EmbeddingService, TransformRequest

__all__ = [
    "TransformConfig", "TransformState", "TransformStats",
    "prepare_batch", "transform_batch", "transform_step",
    "EmbeddingService", "TransformRequest",
]

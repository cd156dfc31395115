"""Out-of-sample embedding: port of ``repro.embed`` (``TSNE.transform``).

:mod:`repro_torch.embed.transform` is the attractive-only descent that
places new points among their k nearest fitted neighbors.  The reference's
continuous-batching ``EmbeddingService`` comes with the observability port.
"""
from repro_torch.embed.transform import (
    TransformConfig, TransformState, TransformStats, prepare_batch,
    transform_batch, transform_step,
)

__all__ = [
    "TransformConfig", "TransformState", "TransformStats",
    "prepare_batch", "transform_batch", "transform_step",
]

"""Synthetic stand-ins for the paper's six benchmark datasets (§4.2).

A numpy copy of ``repro.data.datasets``: the same seed gives the same
arrays in both packages.  Each dataset is generated with the *same size
and dimensionality* as the original and a planted cluster structure (a
Gaussian mixture in a low-dimensional latent space pushed through a random
linear map + noise) so t-SNE has real structure to find and KL-divergence
comparisons between implementations are meaningful.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    dim: int
    classes: int
    latent: int = 10


# size/dim-matched to §4.2 (mouse uses the paper's post-PCA 20 components)
SPECS = {
    "digits": DatasetSpec("digits", 1797, 64, 10),
    "mnist": DatasetSpec("mnist", 70000, 784, 10),
    "cifar10": DatasetSpec("cifar10", 60000, 3072, 10),
    "fashion_mnist": DatasetSpec("fashion_mnist", 70000, 784, 10),
    "svhn": DatasetSpec("svhn", 99289, 3072, 10),
    "mouse_1p3m": DatasetSpec("mouse_1p3m", 1291337, 20, 30, latent=20),
}


def make_dataset(name: str, n: int | None = None, seed: int = 0):
    """Returns (x [n, dim] float32, labels [n] int32)."""
    spec = SPECS[name]
    n = n or spec.n
    # crc32, not hash(): stable across processes regardless of PYTHONHASHSEED
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**16)
    centers = rng.normal(size=(spec.classes, spec.latent)) * 4.0
    labels = rng.integers(0, spec.classes, size=n)
    latent = centers[labels] + rng.normal(size=(n, spec.latent))
    if spec.dim > spec.latent:
        proj = rng.normal(size=(spec.latent, spec.dim)) / np.sqrt(spec.latent)
        x = latent @ proj + 0.3 * rng.normal(size=(n, spec.dim))
    else:
        x = latent[:, : spec.dim]
    return x.astype(np.float32), labels.astype(np.int32)

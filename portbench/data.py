"""Planted-cluster data, made on the device from the seed.

A frozen copy of the recipe of ``repro_torch/data/datasets.py`` (the
paper's six datasets stand in by a Gaussian mixture in a low-dimensional
latent space, pushed through a random linear map plus noise, at each
dataset's published size and dimension), drawn with a ``torch.Generator``
on the device in a few large calls instead of numpy on the host.  The same
seed gives the same arrays on the same device type; the numbers differ
from the program's numpy draw, the distribution does not.
"""
from __future__ import annotations

import torch

SEED_MASK = 2**63 - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for draw ``stream`` of run ``seed`` (any
    whole number; a seed of more than 32 bits is folded, not refused)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream) * 7_919 + 17) & SEED_MASK)
    return g


def planted_clusters(n: int, dim: int, classes: int, latent: int, gen: torch.Generator,
                     device) -> tuple[torch.Tensor, torch.Tensor]:
    """(x [n, dim] float32, labels [n] int64) on ``device``.

    centers ~ 4 N(0, 1) in ``latent`` dimensions, a label drawn uniformly a
    row, the row's latent point its center plus N(0, 1); if ``dim`` exceeds
    ``latent`` the latent points go through a N(0, 1/latent) map to ``dim``
    and get 0.3 N(0, 1) noise, else the first ``dim`` latent coordinates are
    kept (the recipe's post-PCA sets)."""
    f32 = torch.float32
    centers = torch.randn((classes, latent), generator=gen, device=device, dtype=f32) * 4.0
    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    lat = centers[labels] + torch.randn((n, latent), generator=gen, device=device, dtype=f32)
    if dim > latent:
        proj = torch.randn((latent, dim), generator=gen, device=device,
                           dtype=f32) / latent ** 0.5
        # float32 products, not TF32: the data must not depend on a matmul setting
        x = torch.matmul(lat.double(), proj.double()).to(f32)
        x += 0.3 * torch.randn((n, dim), generator=gen, device=device, dtype=f32)
    else:
        x = lat[:, :dim].contiguous()
    return x, labels

"""Plain PyTorch pairwise squared distances: the twin of the CUDA kernel
``csrc/pairwise.cu`` (registry name ``pairwise_sq_dists``).

Port of ``repro/core/_pairwise.py`` with the kernel's clamp at 0 folded in
(``repro/kernels/pairwise_kernel.py`` clamps inside the kernel).
"""
from __future__ import annotations

import torch


def pairwise_sq_dists(q: torch.Tensor, db: torch.Tensor,
                      q_sqn: torch.Tensor | None = None,
                      db_sqn: torch.Tensor | None = None) -> torch.Tensor:
    """max(|q_i|^2 + |db_j|^2 - 2 q_i . db_j, 0).  [Q, D] x [C, D] -> [Q, C]."""
    if q_sqn is None:
        q_sqn = torch.sum(q * q, dim=1)
    if db_sqn is None:
        db_sqn = torch.sum(db * db, dim=1)
    dots = q @ db.T
    return torch.clamp_min(q_sqn[:, None] + db_sqn[None, :] - 2.0 * dots, 0.0)

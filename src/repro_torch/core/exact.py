"""Exact O(N^2) t-SNE quantities: port of ``repro/core/exact.py``, the
correctness oracle for every approximated step and the ``exact`` backend."""
from __future__ import annotations

import torch


def _student_t(y: torch.Tensor):
    diff = y[:, None, :] - y[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    return diff, d2


def exact_repulsion(y: torch.Tensor):
    """Returns (force_unnorm [N,2], Z) with
    force_unnorm_i = sum_{j!=i} (1+d^2)^-2 (y_i - y_j),  Z = sum_{k!=l} (1+d^2)^-1."""
    diff, d2 = _student_t(y)
    w = 1.0 / (1.0 + d2)
    w = w - torch.diag(torch.diag(w))          # zero self terms
    z = torch.sum(w)
    force = torch.sum((w * w)[..., None] * diff, dim=1)
    return force, z


def exact_attraction(y: torch.Tensor, p_dense: torch.Tensor):
    """force_i = sum_j p_ij (1+d^2)^-1 (y_i - y_j); also the attractive KL part."""
    diff, d2 = _student_t(y)
    pq = p_dense / (1.0 + d2)
    force = torch.sum(pq[..., None] * diff, dim=1)
    kl_attr = torch.sum(p_dense * torch.log1p(d2))
    return force, kl_attr


def exact_gradient(y: torch.Tensor, p_dense: torch.Tensor, exaggeration: float = 1.0):
    """dC/dy (eq. 6/7): 4 * (exag * F_attr - F_rep / Z)."""
    fa, _ = exact_attraction(y, p_dense)
    fr, z = exact_repulsion(y)
    return 4.0 * (exaggeration * fa - fr / z)


def exact_kl(y: torch.Tensor, p_dense: torch.Tensor):
    """KL(P||Q) with Q the normalised Student-t similarities of y."""
    _, d2 = _student_t(y)
    w = 1.0 / (1.0 + d2)
    w = w - torch.diag(torch.diag(w))
    q = w / torch.sum(w)
    logs = torch.log(torch.clamp_min(p_dense, 1e-30)) - torch.log(torch.clamp_min(q, 1e-30))
    return torch.sum(torch.where(p_dense > 0, p_dense * logs, 0.0))

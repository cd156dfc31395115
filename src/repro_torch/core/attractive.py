"""Attractive force (paper §3.6, Algorithm 2): port of ``repro/core/attractive.py``.

``attractive_forces_ell`` is the plain twin of the CUDA kernel
``csrc/attractive.cu`` (registry name ``attractive_ell``).
``attractive_forces_frozen`` is the out-of-sample step's force, plain
PyTorch as the reference's is plain XLA.  The reference's
three ELL layouts (``ell``, ``components``, ``blocked``) differ only in how
they use a CPU's or TPU's caches; in the port they all name the one
attractive kernel (:func:`ell_forces`).  ``attractive_forces_edges`` is
the scatter form over the directed KNN edge list.

All return sum_ij p_ij log(1 + d_ij^2), the attractive half of the KL
estimate, beside the force.
"""
from __future__ import annotations

import torch

ELL_IMPLS = ("ell", "components", "blocked")


def attractive_forces_ell(y: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                          row_len: torch.Tensor | None = None):
    """Algorithm 2 over the symmetric ELL matrix.

    y       : [N, 2]      embedding points
    cols    : [N, W] int  neighbor indices (padding: col = row index)
    vals    : [N, W]      symmetric p_ij (already / 2N; padding: 0)
    row_len : [N] int     real entries of each row, or None (all W); the
                          entries at or past it are masked to padding

    Returns (force [N, 2], kl_attr scalar).
    """
    if row_len is not None:
        n, w = cols.shape
        real = torch.arange(w, device=cols.device)[None, :] < row_len[:, None]
        rows = torch.arange(n, dtype=cols.dtype, device=cols.device)[:, None]
        cols = torch.where(real, cols, rows)
        vals = torch.where(real, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    yj = y[cols.long()]                            # [N, W, 2]
    diff = y[:, None, :] - yj
    d2 = torch.sum(diff * diff, dim=-1)
    pq = vals / (1.0 + d2)
    force = torch.sum(pq[..., None] * diff, dim=1)
    kl_attr = torch.sum(vals * torch.log1p(d2))
    return force, kl_attr


def ell_forces(attractive_impl: str):
    """The ELL attractive function for ``attractive_impl`` (any ELL name)."""
    if attractive_impl not in ELL_IMPLS:
        raise ValueError(
            f"unknown attractive_impl {attractive_impl!r}; ELL variants: "
            f"{', '.join(sorted(ELL_IMPLS))} (or 'edges' with an edge list)"
        )
    from repro_torch.kernels import ops     # lazy: ops imports this module
    return ops.attractive_ell


def attractive_forces_frozen(y: torch.Tensor, nbr_y: torch.Tensor, p: torch.Tensor):
    """Attractive force of free points against frozen neighbor coordinates
    (the out-of-sample ``transform``).

    Each new point ``y [M, 2]`` descends toward its k nearest fitted points,
    whose embedding coordinates ``nbr_y [M, K, 2]`` never move, with
    row-normalized similarities ``p [M, K]`` (padding: 0).  Rows are
    independent.

    Returns (force [M, 2], kl_attr [M]: each point's sum p log(1 + d^2)).
    """
    diff = y[:, None, :] - nbr_y
    d2 = torch.sum(diff * diff, dim=-1)
    pq = p / (1.0 + d2)
    force = torch.sum(pq[..., None] * diff, dim=1)
    kl_attr = torch.sum(p * torch.log1p(d2), dim=1)
    return force, kl_attr


def attractive_forces_edges(y: torch.Tensor, src: torch.Tensor,
                            dst: torch.Tensor, w: torch.Tensor):
    """Symmetric attractive force from the directed edge list.

    Each directed KNN edge (i -> j, w = p_{j|i} / 2N) adds
    f = w (1+d^2)^-1 (y_i - y_j) to F_i and -f to F_j, which sums to
    sum_j p_ij (1+d^2)^-1 (y_i - y_j) with p_ij = (p_{j|i} + p_{i|j}) / 2N.
    """
    src = src.long()
    dst = dst.long()
    diff = y[src] - y[dst]
    d2 = torch.sum(diff * diff, dim=-1)
    pq = w / (1.0 + d2)
    f = pq[:, None] * diff
    force = torch.zeros_like(y)
    force.index_add_(0, src, f)
    force.index_add_(0, dst, -f)
    # each ordered pair (i,j) and (j,i) shares d^2: the directed edge
    # carries its w to both, hence the factor 2
    kl_attr = 2.0 * torch.sum(w * torch.log1p(d2))
    return force, kl_attr

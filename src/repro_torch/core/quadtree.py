"""Linear quadtree from sorted Morton codes: port of ``repro/core/quadtree.py``.

The whole build is a fixed-shape data-parallel pipeline (paper §3.3
reformulated): for every level, run boundaries of the depth-L code prefix
mark candidate cells; a candidate is a node iff its point range differs
from the run one level deeper (the compressed quadtree, <= 2N-1 nodes);
flattening the (point, level) keep-grid point-major emits the nodes in DFS
pre-order; ``skip`` rope pointers come from one ``searchsorted`` over the
node starts.  The traversal then walks ``ptr = open ? ptr+1 : skip[ptr]``.

Codes are ``int64`` (see ``core/morton.py``) and every index array is
``int64``; the values equal the reference's ``int32`` arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.morton import DEFAULT_DEPTH


class LinearQuadtree(NamedTuple):
    """Fixed-capacity compressed quadtree in DFS pre-order.

    Valid nodes occupy slots [0, n_nodes); the rest are inert padding with
    ``start == end == N`` so every vectorised op over slots is harmless.
    """

    start: torch.Tensor    # [cap] point-range start (sorted order)
    end: torch.Tensor      # [cap] point-range end (exclusive)
    level: torch.Tensor    # [cap] tree depth of the cell (root region = 0)
    skip: torch.Tensor     # [cap] DFS skip pointer (>= n_nodes terminates)
    n_nodes: torch.Tensor  # [] on the tree's device (no host sync)
    depth: int

    @property
    def count(self) -> torch.Tensor:
        return self.end - self.start

    @property
    def is_leaf(self) -> torch.Tensor:
        slots = torch.arange(self.skip.shape[0], device=self.skip.device)
        return self.skip == slots + 1

    @property
    def capacity(self) -> int:
        return self.start.shape[0]


def _run_ends(boundary: torch.Tensor, n: int) -> torch.Tensor:
    """end[i] = index of the next run boundary strictly after i (else n)."""
    idx = torch.arange(n, device=boundary.device)
    t = torch.where(boundary, idx, n)
    # suffix minimum: sm[i] = min(t[i:]), a reversed cummin
    sm = torch.flip(torch.cummin(torch.flip(t, (0,)), dim=0).values, (0,))
    return torch.cat([sm[1:], sm.new_full((1,), n)])


def build_quadtree(sorted_codes: torch.Tensor, depth: int = DEFAULT_DEPTH,
                   compress: bool = True) -> LinearQuadtree:
    """Build the linear quadtree from *sorted* int64 Morton codes.

    compress=False keeps every per-level run as a node (single-child chains
    included), the daal4py-like uncompressed tree; capacity (depth+1)*N+1.
    """
    n = sorted_codes.shape[0]
    dev = sorted_codes.device
    cap = (2 * n + 1) if compress else ((depth + 1) * n + 1)
    ends, bounds = [], []
    for lvl in range(depth + 1):
        if lvl == 0:
            boundary = torch.zeros((n,), dtype=torch.bool, device=dev)
        else:
            pfx = sorted_codes >> (2 * (depth - lvl))
            prev = torch.cat([pfx[:1] ^ 1, pfx[:-1]])
            boundary = pfx != prev
        boundary[0] = True
        bounds.append(boundary)
        ends.append(_run_ends(boundary, n))

    # node keep rule: boundary AND (max depth OR splits at the next level)
    keeps = []
    for lvl in range(depth + 1):
        if lvl == depth or not compress:
            keeps.append(bounds[lvl])
        else:
            keeps.append(bounds[lvl] & (ends[lvl + 1] < ends[lvl]))

    # [N, depth+1] grids flattened point-major => DFS pre-order
    keep = torch.stack(keeps, dim=1).reshape(-1)
    end_flat = torch.stack(ends, dim=1).reshape(-1)
    start_flat = torch.arange(n, device=dev).repeat_interleave(depth + 1)
    lvl_flat = torch.arange(depth + 1, device=dev).repeat(n)

    rank = torch.cumsum(keep.to(torch.int64), dim=0) - 1
    n_nodes = rank[-1] + 1
    pos = torch.where(keep, rank, cap)   # cap = trash slot of a (cap+1) buffer

    def scatter(values, fill):
        out = torch.full((cap + 1,), fill, dtype=torch.int64, device=dev)
        out.scatter_(0, pos, values)     # kept positions are unique
        return out[:cap]

    start = scatter(start_flat, n)
    end = scatter(end_flat, n)
    level = scatter(lvl_flat, 0)
    # DFS skip pointer: first node whose range starts at/after our end
    skip = torch.searchsorted(start, end, side="left")
    return LinearQuadtree(start=start, end=end, level=level, skip=skip,
                          n_nodes=n_nodes, depth=depth)


def sort_points_by_code(y: torch.Tensor, codes: torch.Tensor):
    """Sort points by Morton code (stable, as ``jnp.argsort``);
    returns (codes_sorted, y_sorted, perm)."""
    perm = torch.argsort(codes, stable=True)
    return codes[perm], y[perm], perm

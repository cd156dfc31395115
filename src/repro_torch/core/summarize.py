"""Per-cell centers of mass (paper §3.4): port of ``repro/core/summarize.py``.

With Morton-sorted points every node is a contiguous range, so the
center of mass of every node at every level is an O(1) difference of
coordinate prefix sums: one cumsum + one gather, no level barriers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.quadtree import LinearQuadtree


class TreeSummary(NamedTuple):
    count: torch.Tensor   # [cap] float, points per node
    sum_y: torch.Tensor   # [cap, 2] coordinate sums per node
    com: torch.Tensor     # [cap, 2] centers of mass (safe for empty nodes)
    side: torch.Tensor    # [cap] cell side length (2*r_span / 2^level)


def summarize(tree: LinearQuadtree, y_sorted: torch.Tensor,
              r_span: torch.Tensor) -> TreeSummary:
    n = y_sorted.shape[0]
    # center before the prefix sum: the cumsum error is O(sqrt(N) eps |y|),
    # so removing the mean keeps float32 COMs accurate at large N
    mu = torch.mean(y_sorted, dim=0, keepdim=True)
    yc = y_sorted - mu
    csum = torch.cat([yc.new_zeros((1, y_sorted.shape[1])),
                      torch.cumsum(yc, dim=0)], dim=0)          # [N+1, 2]
    start = torch.clamp(tree.start, 0, n)
    end = torch.clamp(tree.end, 0, n)
    sum_yc = csum[end] - csum[start]
    count = (end - start).to(y_sorted.dtype)
    com = mu + sum_yc / torch.clamp_min(count, 1.0)[:, None]
    sum_y = sum_yc + count[:, None] * mu
    side = (2.0 * r_span) * torch.exp2(-tree.level.to(y_sorted.dtype))
    return TreeSummary(count=count, sum_y=sum_y, com=com,
                       side=side.to(y_sorted.dtype))

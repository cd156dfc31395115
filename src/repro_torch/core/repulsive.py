"""Repulsive force via Barnes-Hut traversal (paper §3.5): port of
``repro/core/repulsive.py``.

The reference walks the rope-linearised tree with ``vmap`` over a
``lax.while_loop``: each point steps ``ptr = open ? ptr+1 : skip[ptr]``.
:func:`bh_repulsion_sorted` is the plain twin of the CUDA kernel
``csrc/traverse.cu`` (registry name ``bh_traverse``, which has no Pallas
counterpart: the reference compiles its loop with XLA), and the wrapper
``kernels.ops.bh_traverse`` runs it for CPU tensors.  It is the same
walk as a masked lockstep loop over all points at once: every step is a
handful of whole-array ops, and the ``active`` mask (``ptr < n_nodes``)
gates every update and the per-point step counter.  Termination is read
from the device only every ``CHECK_EVERY`` steps, to keep host syncs
rare; the extra masked steps change nothing.  The kernel does each
point's arithmetic in this loop's order, bit for bit.

Self-interaction is excluded exactly: when the current node's range holds
the query point, its summary is used with the point subtracted.  Opening
criterion (paper eq. 9): open iff ``side^2 >= theta^2 * d^2``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.quadtree import LinearQuadtree
from repro_torch.core.summarize import TreeSummary

CHECK_EVERY = 16   # walk steps between host reads of "any point still active"


class RepulsionResult(NamedTuple):
    force: torch.Tensor        # [N, 2] unnormalised: sum_j (1+d^2)^-2 (y_i - y_j)
    z_per_point: torch.Tensor  # [N] sum_j (1+d^2)^-1
    steps: torch.Tensor        # [N] traversal lengths (perf diagnostic)


def theta_squared(theta: float) -> float:
    """theta^2 as the walk compares it: theta rounded to fp32, squared in fp32."""
    return float(torch.tensor(theta, dtype=torch.float32) ** 2)


def bh_repulsion_sorted(y_sorted: torch.Tensor, tree: LinearQuadtree,
                        summary: TreeSummary, theta: float) -> RepulsionResult:
    """Barnes-Hut repulsion for points in Morton-sorted order."""
    n = y_sorted.shape[0]
    dev = y_sorted.device
    dtype = y_sorted.dtype
    theta2 = theta_squared(theta)
    cap = tree.capacity
    not_leaf = ~tree.is_leaf
    side2 = summary.side * summary.side
    p = torch.arange(n, device=dev)

    ptr = torch.zeros(n, dtype=torch.int64, device=dev)
    force = torch.zeros((n, 2), dtype=dtype, device=dev)
    z = torch.zeros(n, dtype=dtype, device=dev)
    steps = torch.zeros(n, dtype=torch.int64, device=dev)
    it = 0
    while True:
        active = ptr < tree.n_nodes
        if it % CHECK_EVERY == 0 and not bool(active.any()):
            break
        it += 1
        k = torch.clamp_max(ptr, cap - 1)
        inside = (tree.start[k] <= p) & (p < tree.end[k])
        cnt_eff = summary.count[k] - inside.to(dtype)
        sum_eff = summary.sum_y[k] - torch.where(inside[:, None], y_sorted, 0.0)
        com = sum_eff / torch.clamp_min(cnt_eff, 1.0)[:, None]
        diff = y_sorted - com
        d2 = torch.sum(diff * diff, dim=1)
        open_ = not_leaf[k] & (side2[k] >= theta2 * d2)
        w = torch.where(open_ | ~active, 0.0, cnt_eff)   # contribute iff accepted
        q = 1.0 / (1.0 + d2)
        z = z + w * q
        force = force + (w * q * q)[:, None] * diff
        ptr = torch.where(active, torch.where(open_, ptr + 1, tree.skip[k]), ptr)
        steps = steps + active.to(torch.int64)
    return RepulsionResult(force=force, z_per_point=z, steps=steps)

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

The kernel first packs each node into a 32-byte record (its plain twin
is :func:`pack_nodes`) and then walks the records, a thread a point.
:func:`warp_walk` is the schedule of a warp-shared walk over the same
records (``variants/traverse_warp.cu``): it counts how far the walks of a
warp's 32 points diverge.  The tests and ``chip_smoke.py`` call both;
the fit calls neither.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.quadtree import LinearQuadtree
from repro_torch.core.summarize import TreeSummary

CHECK_EVERY = 16   # walk steps between host reads of "any point still active"
RECORD_WORDS = 8   # a packed node: com_x, com_y, count, side^2 (fp32 bits), start,
                   # end, skip, 0


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


def pack_nodes(tree: LinearQuadtree, summary: TreeSummary) -> torch.Tensor:
    """Plain twin of ``csrc/traverse.cu``'s pack kernel: [cap, RECORD_WORDS]
    int32, a node's com_x, com_y, count and side^2 (their fp32 bits), then
    its start, end and skip, and 0.  com = sum_y / max(count, 1) and side *
    side are what :func:`bh_repulsion_sorted` computes for a node that
    does not hold the point (it subtracts an exact zero first).  The kernel
    writes the valid nodes [0, n_nodes) only; this writes every slot."""
    count = summary.count
    com = summary.sum_y / torch.clamp_min(count, 1.0)[:, None]
    hot = torch.stack([com[:, 0], com[:, 1], count, summary.side * summary.side], dim=1)
    links = torch.stack([tree.start, tree.end, tree.skip, torch.zeros_like(tree.skip)], dim=1)
    return torch.cat([hot.view(torch.int32), links.to(torch.int32)], dim=1)


def warp_walk(y_sorted: torch.Tensor, records: torch.Tensor, sum_y: torch.Tensor,
              n_nodes: torch.Tensor, theta: float, lanes: int = 32):
    """The schedule of a warp-shared walk (``variants/traverse_warp.cu``) in
    plain PyTorch.

    Groups of ``lanes`` Morton-consecutive points step together through
    the union of their walks in pre-order: the group's pointer is the least
    of its points' pointers, every step reads that node's record
    (:func:`pack_nodes`'s layout, valid for [0, n_nodes)), and a point
    whose own pointer is the group's visits the node with
    :func:`bh_repulsion_sorted`'s operations; ``sum_y`` is read only for a
    node whose range holds the point.  Returns (the twin's
    RepulsionResult, bit for bit; the union's length for each group)."""
    n = y_sorted.shape[0]
    dev, dtype = y_sorted.device, y_sorted.dtype
    cap = records.shape[0]
    theta2 = theta_squared(theta)
    hot = records[:, :4].contiguous().view(dtype)
    com, count, side2 = hot[:, :2], hot[:, 2], hot[:, 3]
    start, end, skip = (records[:, c].to(torch.int64) for c in (4, 5, 6))
    groups = -(-n // lanes)
    ptr = torch.full((groups * lanes,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                     device=dev)
    ptr[:n] = 0            # a lane past the last point is done from the start
    p = torch.arange(n, device=dev)
    force = torch.zeros((n, 2), dtype=dtype, device=dev)
    z = torch.zeros(n, dtype=dtype, device=dev)
    steps = torch.zeros(n, dtype=torch.int64, device=dev)
    union = torch.zeros(groups, dtype=torch.int64, device=dev)
    it = 0
    while True:
        w = torch.amin(ptr.view(groups, lanes), dim=1)       # each group's pointer
        live = w < n_nodes
        if it % CHECK_EVERY == 0 and not bool(live.any()):
            break
        it += 1
        union = union + live.to(torch.int64)
        w_lane = torch.repeat_interleave(w, lanes)[:n]
        visit = (ptr[:n] == w_lane) & (w_lane < n_nodes)
        k = torch.clamp_max(w_lane, cap - 1)
        inside = visit & (start[k] <= p) & (p < end[k])
        cnt = torch.where(inside, count[k] - 1.0, count[k])
        c = com[k]
        c[inside] = ((sum_y[k[inside]] - y_sorted[inside])
                     / torch.clamp_min(cnt[inside], 1.0)[:, None])
        diff = y_sorted - c
        d2 = torch.sum(diff * diff, dim=1)
        open_ = (skip[k] != k + 1) & (side2[k] >= theta2 * d2)
        accept = visit & ~open_
        q = 1.0 / (1.0 + d2)
        z = torch.where(accept, z + cnt * q, z)
        force = torch.where(accept[:, None], force + (cnt * q * q)[:, None] * diff, force)
        ptr[:n] = torch.where(visit, torch.where(open_, k + 1, skip[k]), ptr[:n])
        steps = steps + visit.to(torch.int64)
    return RepulsionResult(force=force, z_per_point=z, steps=steps), union

"""daal4py-like *naive* BH t-SNE steps, the paper's baseline: port of
``repro/core/naive.py``.

The paper's baseline (daal4py v2021.6) builds the quadtree level by level,
re-partitioning every point at every level, runs a *sequential* bottom-up
summarization with level barriers, and a scalar-inner-loop attractive pass.
These emulations keep that work profile (a pass over all points, a stable
sort and a segment sum at every level; one neighbour slot at a time), so
timing them against the optimised step measures the paper's algorithmic
win.  Do not fuse the levels or vectorise over the slots: the point of the
module is that it does the baseline's work.  It has no kernel of its own;
on the card it runs as PyTorch's own kernels.

One departure from the reference: the segment sums of the centres of mass
accumulate in float64 (the reference sums in float32).  At the mouse set's
size a coarse cell holds hundreds of thousands of points, and a float32
sum that long carries an order-dependent error near 1e-5 of its value, so
the card's atomic adds and the CPU's loop could disagree beyond
``rtol=1e-5``.  Summed in float64 and rounded once, the result does not
depend on the order of the adds.
"""
from __future__ import annotations

import torch

from repro_torch.core import morton


def naive_build_and_summarize(y: torch.Tensor, depth: int = morton.DEFAULT_DEPTH):
    """Level-by-level build: every level re-buckets all points against the
    running cell centre and re-sorts them, then sums each level's cells.

    Returns (ids [N] int64, coms: ``depth`` tensors [N, 2], counts: ``depth``
    tensors [N]): the finest level's cell ids (the reference's ``uint32``
    values; depth <= 16 keeps them in 32 bits), and for each level the
    cells' centres of mass and point counts in sorted-id order, the first
    (cells at that level) rows used, as ``segment_sum(num_segments=N)``."""
    morton.check_depth(depth)
    n = y.shape[0]
    cent, r_span = morton.span_radius(y)
    cx = cent[0].expand(n).clone()
    cy = cent[1].expand(n).clone()
    half = r_span
    ids = torch.zeros((n,), dtype=torch.int64, device=y.device)
    ones = torch.ones((n,), dtype=y.dtype, device=y.device)
    coms, counts = [], []
    for _ in range(depth):
        qx = (y[:, 0] > cx).to(torch.int64)
        qy = (y[:, 1] > cy).to(torch.int64)
        ids = ids * 4 + (qx + 2 * qy)
        half = half * 0.5
        cx = cx + (2.0 * qx.to(y.dtype) - 1.0) * half
        cy = cy + (2.0 * qy.to(y.dtype) - 1.0) * half
        # per-level re-partition: sort all points by this level's cell id
        order = torch.argsort(ids, stable=True)
        ids_s = ids[order]
        y_s = y[order]
        # level-synchronised summarization (one barrier per level)
        seg_new = torch.ones((n,), dtype=torch.int64, device=y.device)
        seg_new[1:] = (ids_s[1:] != ids_s[:-1]).to(torch.int64)
        seg = torch.cumsum(seg_new, 0) - 1
        csum = torch.zeros((n, 2), dtype=torch.float64, device=y.device).index_add_(
            0, seg, y_s.to(torch.float64))
        ccnt = torch.zeros((n,), dtype=y.dtype, device=y.device).index_add_(0, seg, ones)
        coms.append((csum / torch.clamp_min(ccnt, 1.0).to(torch.float64)[:, None]).to(y.dtype))
        counts.append(ccnt)
    return ids, coms, counts


def naive_attractive(y: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Algorithm 2 with a *sequential* loop over the K neighbour slots (the
    pre-SIMD baseline), each slot vectorised over the rows: the reference's
    ``vmap`` over rows of a ``fori_loop`` over K.  Returns the force [N, 2]."""
    cols = cols.long()
    acc = torch.zeros_like(y)
    for j in range(cols.shape[1]):
        diff = y - y[cols[:, j]]
        d2 = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]
        pq = vals[:, j] / (1.0 + d2)
        acc = acc + pq[:, None] * diff
    return acc

"""Exact K-nearest-neighbors (paper §3.1): port of ``repro/core/knn.py::knn``.

Blocked brute force: for each block of ``block_q`` query rows the
``[block_q, block_db]`` squared-distance tiles come from the kernel
registry's ``pairwise_sq_dists`` (the CUDA kernel on the card, its plain
twin on the CPU), and the top-k is a streaming ``torch.topk`` merge over
the database chunks, as the reference merges with ``lax.top_k`` outside
its Pallas kernel.  Exact, not approximate.

Unlike the reference, ``x`` is not padded to block multiples: the last
query block and the last database chunk are simply shorter (the kernel
masks ragged edges), so only the diagonal needs masking.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def knn(x: torch.Tensor, k: int, block_q: int = 512, block_db: int = 2048):
    """Exact KNN of the rows of ``x`` among themselves, self excluded.

    Returns (idx [N, k] int32, d2 [N, k]) on ``x``'s device, each row
    ascending by distance.  Ties may be broken differently from JAX's
    ``lax.top_k``.
    """
    n = x.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < n={n}")
    x = x.contiguous()
    sqn = torch.sum(x * x, dim=1)
    big = torch.finfo(x.dtype).max
    out_d, out_i = [], []
    for q0 in range(0, n, block_q):
        q1 = min(q0 + block_q, n)
        q_idx = torch.arange(q0, q1, device=x.device)
        best_d = torch.full((q1 - q0, k), big, dtype=x.dtype, device=x.device)
        best_i = torch.full((q1 - q0, k), -1, dtype=torch.int64, device=x.device)
        for c0 in range(0, n, block_db):
            c1 = min(c0 + block_db, n)
            col = torch.arange(c0, c1, device=x.device)
            d2 = ops.pairwise_sq_dists(x[q0:q1], x[c0:c1], sqn[q0:q1], sqn[c0:c1])
            if c0 < q1 and q0 < c1:      # this chunk holds some query rows
                d2 = d2.masked_fill(col[None, :] == q_idx[:, None], big)
            cat_d = torch.cat([best_d, d2], dim=1)
            cat_i = torch.cat([best_i, col.expand(q1 - q0, -1)], dim=1)
            best_d, arg = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
            best_i = torch.gather(cat_i, 1, arg)
        out_d.append(best_d)
        out_i.append(best_i)
    d2 = torch.clamp_min(torch.cat(out_d, dim=0), 0.0)
    return torch.cat(out_i, dim=0).to(torch.int32), d2

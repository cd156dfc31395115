"""Exact K-nearest-neighbors (paper §3.1): port of ``repro/core/knn.py``.

Blocked brute force: for each block of ``block_q`` query rows the
``[block_q, block_db]`` squared-distance tiles come from the kernel
registry's ``pairwise_sq_dists`` (the CUDA kernel on the card, its plain
twin on the CPU), and the top-k is a streaming ``torch.topk`` merge over
the database chunks, as the reference merges with ``lax.top_k`` outside
its Pallas kernel.  Exact, not approximate.

Ties are broken as ``lax.top_k`` breaks them: among equal distances the
lower database index wins.  ``torch.topk`` gives no order among ties, so
the merge ranks 64-bit keys, the distance's fp32 bits in the high word
and the column index in the low one (both written in place through an
int32 view of the keys: the byte order is little-endian on the CPU and
the card).  A distance is >= +0.0 (the tile is max(..., 0), whose
operands never make a -0.0), so its bits as an integer order as the
floats do, and equal distances order by index.

Unlike the reference, ``x`` is not padded to block multiples: the last
query block and the last database chunk are simply shorter (the kernel
masks ragged edges), so only the diagonal needs masking.  ``knn`` and
``knn_query`` share the loop and the merge.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def knn(x: torch.Tensor, k: int, block_q: int = 512, block_db: int = 2048):
    """Exact KNN of the rows of ``x`` among themselves, self excluded.

    Returns (idx [N, k] int32, d2 [N, k]) on ``x``'s device, each row
    ascending by distance, equal distances by index (as ``lax.top_k``).
    """
    n = x.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < n={n}")
    return _blocked_topk(x, x, k, block_q, block_db, exclude_self=True)


def knn_query(q: torch.Tensor, db: torch.Tensor, k: int, block_q: int = 512,
              block_db: int = 2048):
    """Exact KNN of query points against a fixed database (out-of-sample):
    port of ``repro/core/knn.py::knn_query``.

    Rows of ``q`` are not members of ``db``, so nothing is excluded: the
    nearest database point is a valid answer.  Returns (idx [M, k] int32
    into db, d2 [M, k]), ordered as :func:`knn` orders them.
    """
    n = db.shape[0]
    if k > n:
        raise ValueError(f"k={k} must be <= database size n={n}")
    return _blocked_topk(q, db, k, block_q, block_db, exclude_self=False)


def _blocked_topk(q: torch.Tensor, db: torch.Tensor, k: int, block_q: int, block_db: int,
                  exclude_self: bool):
    """The k nearest rows of ``db`` to each row of ``q`` (row i of ``q`` is
    row i of ``db`` when ``exclude_self``), merged chunk by chunk."""
    m, n = q.shape[0], db.shape[0]
    q = q.contiguous()
    db = db.contiguous()
    db_sqn = torch.sum(db * db, dim=1)
    q_sqn = db_sqn if exclude_self else torch.sum(q * q, dim=1)
    big = torch.finfo(q.dtype).max
    out = []
    for q0 in range(0, m, block_q):
        q1 = min(q0 + block_q, m)
        q_idx = torch.arange(q0, q1, device=q.device)
        # (big, index n): never kept, since every row has k real columns
        best = torch.full((q1 - q0, k), (_float_bits(big) << 32) | n, dtype=torch.int64,
                          device=q.device)
        for c0 in range(0, n, block_db):
            c1 = min(c0 + block_db, n)
            col = torch.arange(c0, c1, dtype=torch.int32, device=q.device)
            d2 = ops.pairwise_sq_dists(q[q0:q1], db[c0:c1], q_sqn[q0:q1], db_sqn[c0:c1])
            if exclude_self and c0 < q1 and q0 < c1:      # this chunk holds some query rows
                d2 = d2.masked_fill(col[None, :] == q_idx[:, None], big)
            keys = torch.empty((q1 - q0, k + c1 - c0), dtype=torch.int64, device=q.device)
            keys[:, :k] = best
            write_keys(keys[:, k:], d2, col)
            best = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
        out.append(best)
    words = torch.cat(out, dim=0).view(torch.int32)
    return words[:, 0::2].contiguous(), words[:, 1::2].contiguous().view(torch.float32)


def write_keys(keys: torch.Tensor, d: torch.Tensor, low: torch.Tensor) -> None:
    """Fill the int64 ``keys`` (last dimension of stride 1) so that they
    order as (d, low): the fp32 bits of ``d`` (>= +0.0) in the high word,
    ``low`` (int32, >= 0, broadcast over the leading dimensions) in the
    low word."""
    words = keys.view(torch.int32)
    words[..., 0::2] = low
    words[..., 1::2] = d.view(torch.int32)


def key_low_words(keys: torch.Tensor) -> torch.Tensor:
    """The low words of int64 keys written by :func:`write_keys`, as int64."""
    return keys.view(torch.int32)[..., 0::2].long()


def _float_bits(v: float) -> int:
    """The bits of fp32 ``v`` as a Python int."""
    return int(torch.tensor(v, dtype=torch.float32).view(torch.int32))

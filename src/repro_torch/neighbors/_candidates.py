"""Shared candidate-set machinery of the approximate neighbor backends:
port of ``repro/neighbors/_candidates.py``.

Both ``rp_forest`` and ``nn_descent`` reduce to the same inner loop: gather
a fixed-width candidate set per point, score it with exact squared
distances, and fold it into a running top-k while dropping duplicate and
invalid columns.

:func:`merge_topk` repeats the reference bit for bit.  The reference sorts
each row's columns by index with a stable sort, masks repeats, and takes
``lax.top_k`` of the negated distances, which keeps equal distances in
column order.  ``torch.topk`` gives ties no order, so the port ranks
64-bit keys (``core/knn.py``): a distance's fp32 bits above the column's
position in the index-sorted row.
"""
from __future__ import annotations

import torch

from repro_torch.core.knn import key_low_words, write_keys

# bytes of one row block's int64 keys in merge_topk: bounds the sort's and
# the top-k's temporaries at a million rows
MERGE_BLOCK_BYTES = 1 << 28


def merge_topk(best_i: torch.Tensor, best_d: torch.Tensor, cand_i: torch.Tensor,
               cand_d: torch.Tensor, k: int, n: int, exclude_self: bool = True):
    """Fold candidate columns into a running top-k, row by row.

    ``best_* [N, K0]`` and ``cand_* [N, C]`` are row-aligned; candidates with
    index outside ``[0, n)`` or equal to the row index are dropped, and of
    duplicate indices the copy that a stable sort by index puts first (the
    one from ``best``) is kept.  Returns ``(idx [N, k] int32, d2 [N, k])``
    sorted ascending by distance, equal distances in index order.  Distances
    are squared distances (>= -0.0).

    ``exclude_self=False`` skips the row-index drop: the query path, where
    rows are new points and candidate ``i`` in row ``i`` is a coincidence.
    """
    m = best_i.shape[0]
    width = best_i.shape[1] + cand_i.shape[1]
    block = max(1, MERGE_BLOCK_BYTES // (8 * width))
    if m <= block:
        return _merge_rows(best_i, best_d, cand_i, cand_d, k, n, exclude_self, 0)
    parts = [_merge_rows(best_i[r:r + block], best_d[r:r + block], cand_i[r:r + block],
                         cand_d[r:r + block], k, n, exclude_self, r)
             for r in range(0, m, block)]
    return torch.cat([i for i, _ in parts]), torch.cat([d for _, d in parts])


def _merge_rows(best_i, best_d, cand_i, cand_d, k: int, n: int, exclude_self: bool,
                row0: int):
    """:func:`merge_topk` of rows ``row0 ..`` (their indices matter for the
    self drop)."""
    dev = best_i.device
    ci = torch.cat([best_i, cand_i], dim=1).to(torch.int32)
    cd = torch.cat([best_d, cand_d], dim=1)
    big = torch.finfo(cd.dtype).max
    invalid = (ci < 0) | (ci >= n)
    if exclude_self:
        rows = torch.arange(row0, row0 + ci.shape[0], dtype=torch.int32, device=dev)
        invalid |= ci == rows[:, None]
    cd = cd.masked_fill(invalid, big)
    # sort columns by index so duplicates become adjacent, then mask repeats
    ci, order = torch.sort(ci, dim=1, stable=True)
    cd = torch.gather(cd, 1, order)
    dup = torch.zeros_like(ci, dtype=torch.bool)
    dup[:, 1:] = ci[:, 1:] == ci[:, :-1]
    cd = cd.masked_fill(dup, big)
    # (distance, position) keys; -0.0 + 0.0 is +0.0, so a -0.0 ties with
    # +0.0 as the reference's float comparison has it
    keys = torch.empty(cd.shape, dtype=torch.int64, device=dev)
    write_keys(keys, cd + 0.0, torch.arange(cd.shape[1], dtype=torch.int32, device=dev))
    pos = key_low_words(torch.topk(keys, k, dim=1, largest=False, sorted=True).values)
    return torch.gather(ci, 1, pos), torch.gather(cd, 1, pos)


def candidate_sq_dists(x: torch.Tensor, cand: torch.Tensor, block_rows: int = 512,
                       q: torch.Tensor | None = None) -> torch.Tensor:
    """``d2[i, j] = ||row_i - x[cand[i, j]]||^2``, computed in row blocks.

    Rows come from ``q`` when given (out-of-sample queries scored against
    the reference set ``x``), else from ``x`` itself.  ``cand`` entries are
    clipped to ``[0, n)`` for the gather; callers mask out-of-range columns
    themselves (merge_topk does).  Row blocking bounds the ``[B, C, D]``
    gather instead of materialising ``[N, C, D]``.
    """
    n = x.shape[0]
    rows = x if q is None else q
    m = rows.shape[0]
    sqn = torch.sum(x * x, dim=1)
    cand = torch.clamp(cand, 0, n - 1).long()
    out = torch.empty(cand.shape, dtype=x.dtype, device=x.device)
    for r0 in range(0, m, block_rows):
        xb = rows[r0:r0 + block_rows]
        cb = cand[r0:r0 + block_rows]
        dots = torch.einsum("bd,bcd->bc", xb, x[cb])          # [B, C, D] gather
        d2 = torch.sum(xb * xb, dim=1)[:, None] + sqn[cb] - 2.0 * dots
        out[r0:r0 + block_rows] = torch.clamp_min(d2, 0.0)
    return out


def draw_offsets(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """k distinct offsets in [1, n) from ``gen`` (the reference draws them
    with ``jax.random.choice`` without replacement)."""
    return 1 + torch.randperm(n - 1, generator=gen)[:k]


def seed_graph(x: torch.Tensor, offsets: torch.Tensor, block_rows: int = 512):
    """A valid (if poor) starting graph: ``len(offsets)`` distinct non-self
    neighbors per row, ``idx[i] = (i + offsets) % n``.

    Shared offsets keep every slot a real point, so backends that merge
    into this state can never emit an invalid index.
    """
    n = x.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=x.device)
    idx = ((rows[:, None] + offsets.to(x.device)[None, :]) % n).to(torch.int32)
    return idx, candidate_sq_dists(x, idx, block_rows=block_rows)

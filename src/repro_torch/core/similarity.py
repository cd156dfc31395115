"""Sparse input-similarity construction (paper §2.2.1), port of
``repro/core/similarity.py``.

Symmetric p_ij = (p_{j|i} + p_{i|j}) / 2N over the union of the directed
KNN neighborhoods.  ``symmetrize_ell`` / ``symmetrize_ell_chunked`` /
``dense_p_matrix`` are host numpy, copied from the reference so that the
output is bit-identical; ``edge_list`` is on torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def edge_list(cols: torch.Tensor, cond_p: torch.Tensor, n: int | None = None):
    """Directed KNN edges: (src [NK], dst [NK], w [NK] = p_{dst|src} / 2N)."""
    nn, k = cols.shape
    n = n or nn
    src = torch.arange(nn, dtype=torch.int32, device=cols.device).repeat_interleave(k)
    dst = cols.reshape(-1).to(torch.int32)
    w = cond_p.reshape(-1) / (2.0 * n)
    return src, dst, w


def _merge_runs(r2, c2, v2, key):
    """Key-sort, sum duplicate (row, col) runs, rank within row."""
    order = np.argsort(key, kind="stable")
    key, r2, c2, v2 = key[order], r2[order], c2[order], v2[order]
    new_run = np.empty(key.shape, bool)
    new_run[0] = True
    new_run[1:] = key[1:] != key[:-1]
    run_id = np.cumsum(new_run) - 1
    n_runs = run_id[-1] + 1
    val = np.zeros(n_runs, np.float64)
    np.add.at(val, run_id, v2)
    row = r2[new_run]
    col = c2[new_run]
    first_of_row = np.empty(n_runs, bool)
    first_of_row[0] = True
    first_of_row[1:] = row[1:] != row[:-1]
    row_first_idx = np.maximum.accumulate(np.where(first_of_row, np.arange(n_runs), 0))
    rank = np.arange(n_runs) - row_first_idx
    return row, rank, col, val


def symmetrize_ell(cols, cond_p):
    """Host-side symmetrization to a regular ELL layout.

    cols   : [N, K] int neighbor indices
    cond_p : [N, K] conditional p_{j|i}
    Returns (sym_cols [N, W] int32, sym_vals [N, W] float64) where padding
    entries have col = row-index and val = 0; sum(sym_vals) == 1.
    """
    cols = np.asarray(cols)
    cond_p = np.asarray(cond_p)
    n, k = cols.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cs = cols.reshape(-1).astype(np.int64)
    vs = cond_p.reshape(-1).astype(np.float64)
    # both orientations; duplicates (mutual neighbors) sum to p_{j|i}+p_{i|j}
    r2 = np.concatenate([rows, cs])
    c2 = np.concatenate([cs, rows])
    v2 = np.concatenate([vs, vs])
    row, rank, col, val = _merge_runs(r2, c2, v2, r2 * n + c2)
    w = int(rank.max()) + 1 if len(rank) else 1
    sym_cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, w))
    sym_vals = np.zeros((n, w), np.float64)
    sym_cols[row, rank] = col.astype(np.int32)
    sym_vals[row, rank] = val / (2.0 * n)
    return sym_cols, sym_vals


def ell_row_lengths(cols) -> np.ndarray:
    """Real entries of each ELL row: [N] int32, one past the row's last
    entry whose column is not the row itself.

    :func:`symmetrize_ell` puts a row's real entries first and pads it
    with col = row (val = 0); the KNN excludes self, so no real entry has
    col = row and this is the count of real entries.  On any ELL graph an
    entry with col = row adds nothing to the attractive force or KL
    (y_i - y_j = 0), so dropping the trailing ones is exact.
    """
    cols = np.asarray(cols)
    n, w = cols.shape
    real = cols != np.arange(n)[:, None]
    last = w - np.argmax(real[:, ::-1], axis=1)
    return np.where(real.any(axis=1), last, 0).astype(np.int32)


def symmetrize_ell_chunked(cols, cond_p, chunk_size: int):
    """:func:`symmetrize_ell` in row chunks: bit-identical output, but the
    2NK-edge sort never materialises; transients are O(chunk * K) beyond
    the O(N * K) inputs and outputs."""
    chunk = int(chunk_size)
    if chunk <= 0:
        raise ValueError(f"chunk_size={chunk_size} must be >= 1")
    cols = np.asarray(cols)
    cond_p = np.asarray(cond_p)
    n, k = cols.shape

    # transpose: incoming edges of row j live at t_order[t_ptr[j]:t_ptr[j+1]]
    flat_cols = cols.reshape(-1).astype(np.int64)
    indeg = np.bincount(flat_cols, minlength=n)
    t_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(indeg, out=t_ptr[1:])
    t_order = np.argsort(flat_cols, kind="stable")
    t_src = (t_order // k).astype(np.int64)          # source row per in-edge
    t_val = cond_p.reshape(-1).astype(np.float64)[t_order]

    parts = []
    w = 1
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        r2 = np.concatenate([
            np.repeat(np.arange(s, e, dtype=np.int64), k),            # outgoing
            np.repeat(np.arange(s, e, dtype=np.int64), indeg[s:e]),   # incoming
        ])
        c2 = np.concatenate([cols[s:e].reshape(-1).astype(np.int64),
                             t_src[t_ptr[s]:t_ptr[e]]])
        v2 = np.concatenate([cond_p[s:e].reshape(-1).astype(np.float64),
                             t_val[t_ptr[s]:t_ptr[e]]])
        row, rank, col, val = _merge_runs(r2, c2, v2, (r2 - s) * n + c2)
        w = max(w, int(rank.max()) + 1 if len(rank) else 1)
        parts.append((row.astype(np.int64), rank.astype(np.int32),
                      col.astype(np.int32), val))

    sym_cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, w))
    sym_vals = np.zeros((n, w), np.float64)
    for row, rank, col, val in parts:
        sym_cols[row, rank] = col
        sym_vals[row, rank] = val / (2.0 * n)
    return sym_cols, sym_vals


def dense_p_matrix(cols, cond_p):
    """Dense symmetric P (for the exact oracle / small-N tests)."""
    cols = np.asarray(cols)
    cond_p = np.asarray(cond_p)
    n, k = cols.shape
    p = np.zeros((n, n), np.float64)
    rows = np.repeat(np.arange(n), k)
    p[rows, cols.reshape(-1)] = cond_p.reshape(-1)
    p = (p + p.T) / (2.0 * n)
    np.fill_diagonal(p, 0.0)
    return p

"""The state that crosses between ``repro`` and ``repro_torch``, from numpy.

t-SNE has no weights.  What one package's run hands the other is the
fitted sparse input-similarity graph, the descent state (whole, or split
over a device mesh by :func:`shard_state`) and a fitted random-projection
forest; they cross as numpy arrays (never framework objects), so this
module needs nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.similarity import ell_row_lengths
from repro_torch.core.tsne import NeighborGraph, TsneState
from repro_torch.device import resolve_device
from repro_torch.neighbors.rp_forest import RPForestIndex


def graph_from_numpy(p_cols, p_vals, p_logp, n: int | None = None, *,
                     edges=None, device=None,
                     dtype: torch.dtype = torch.float32) -> NeighborGraph:
    """A :class:`NeighborGraph` from ELL planes (and optionally the directed
    edge list ``(src, dst, w)``) held as numpy arrays.  ``p_len`` is derived
    from ``p_cols`` as :func:`preprocess` derives it."""
    dev = resolve_device(device)
    p_len = torch.tensor(ell_row_lengths(np.asarray(p_cols)), device=dev)
    p_cols = torch.tensor(np.asarray(p_cols, np.int32), device=dev)
    p_vals = torch.tensor(np.asarray(p_vals), device=dev).to(dtype)
    n = int(p_cols.shape[0]) if n is None else int(n)
    if edges is not None:
        src, dst, w = (np.asarray(a) for a in edges)
        edge_src = torch.tensor(src.astype(np.int32), device=dev)
        edge_dst = torch.tensor(dst.astype(np.int32), device=dev)
        edge_w = torch.tensor(w, device=dev).to(dtype)
    else:
        edge_src = edge_dst = torch.zeros((1,), dtype=torch.int32, device=dev)
        edge_w = torch.zeros((1,), dtype=dtype, device=dev)
    return NeighborGraph(
        p_cols=p_cols, p_vals=p_vals, p_len=p_len, edge_src=edge_src, edge_dst=edge_dst,
        edge_w=edge_w, p_logp=torch.tensor(float(p_logp), dtype=dtype, device=dev),
        n=n, has_edges=edges is not None)


def state_from_numpy(y, velocity=None, gains=None, iteration: int = 0, *,
                     device=None, dtype: torch.dtype = torch.float32) -> TsneState:
    """A :class:`TsneState` from numpy arrays; velocity defaults to zeros
    and gains to ones, as a fresh ``init_state`` has them."""
    dev = resolve_device(device)
    y_t = torch.tensor(np.asarray(y), device=dev).to(dtype)
    vel = torch.zeros_like(y_t) if velocity is None \
        else torch.tensor(np.asarray(velocity), device=dev).to(dtype)
    gn = torch.ones_like(y_t) if gains is None \
        else torch.tensor(np.asarray(gains), device=dev).to(dtype)
    return TsneState(y=y_t, velocity=vel, gains=gn, iteration=int(np.asarray(iteration)))


def shard_state(mesh, state: TsneState) -> list[TsneState]:
    """A carried-across :class:`TsneState` split row-wise over a
    ``core.distributed.Mesh``: shard r holds rows ``r * N / S ..`` of y,
    velocity and gains on ``mesh.devices[r]`` (N divisible by S)."""
    from repro_torch.core.distributed import shard_rows   # lazy: distributed builds on core
    parts = (shard_rows(mesh, t) for t in (state.y, state.velocity, state.gains))
    return [TsneState(y=y, velocity=v, gains=g, iteration=state.iteration)
            for y, v, g in zip(*parts)]


def forest_index_from_numpy(x_ref, leaves, dirs, thrs, *, device=None) -> RPForestIndex:
    """An :class:`RPForestIndex` from a forest held as numpy arrays:
    reference points ``x_ref [N, D]``, ``leaves [T, 2^depth, leaf_size]``,
    hyperplanes ``dirs [T, depth, D]`` and ``thrs`` (level l: ``[T, 2^l]``),
    as ``repro.neighbors.rp_forest.build_forest_index`` returns them."""
    dev = resolve_device(device)
    return RPForestIndex(
        x_ref=torch.tensor(np.asarray(x_ref, np.float32), device=dev),
        leaves=torch.tensor(np.asarray(leaves, np.int64), device=dev),
        dirs=torch.tensor(np.asarray(dirs, np.float32), device=dev),
        thrs=tuple(torch.tensor(np.asarray(t, np.float32), device=dev) for t in thrs))

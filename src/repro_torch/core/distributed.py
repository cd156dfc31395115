"""Distributed Barnes-Hut t-SNE and the two KNN rings: port of ``repro/core/distributed.py``.

The reference is single-controller: one process drives a ``Mesh`` of
devices through ``shard_map``, and its tests run it on 8 host devices of
one CPU.  The port does the same without ``torch.distributed``: a
:class:`Mesh` is a tuple of ``torch.device``s driven from one process,
and a device may appear more than once.  A sharded array is a list of
per-shard tensors, row block r on ``mesh.devices[r]``
(:func:`shard_rows`, :func:`gather_rows`).  The mesh and its collectives
live in :mod:`repro_torch.distributed.collectives` (multi-device training
shares them) and are re-exported here.  The three collectives the
reference uses are copies between the shards' devices: :func:`all_gather`,
:func:`psum` and the ring :func:`ring_permute` (rank r receives from
r - 1).  Every copy is ``non_blocking`` and nothing here reads a value
back to the host, so the host issues one shard's work after another and
separate cards run it at once.  ``Mesh((cuda:0,) * 4)`` runs four real
shards on one card, one after the other; ``Mesh((cpu,) * 8)`` stands for
the reference tests' 8 forced host devices.

Distribution strategy, as the reference's: *points are sharded, the tree
is replicated*.  Every shard all-gathers the embedding (N x 2, small next
to the per-point work), rebuilds the same Morton quadtree and walks only
its own points, at their positions in the global Morton order; the
attractive forces run over its own rows of the graph against the global
y; Z and the KL terms are psum'd.

Two KNN rings:

* :func:`ring_knn`, the exact oracle: each shard keeps its queries and
  the database shards travel round the ring, each hop's distance tile
  (the ``pairwise_sq_dists`` kernel) merged into a running top-k;
* :func:`ring_knn_approx`, the scalable path: each shard builds an
  rp-tree forest over its own points, and the (query block, running
  global top-k) state travels instead; the host shard routes the visiting
  queries down its forest, scores the leaf candidates exactly and folds
  them in with global indices, in row blocks of ``block_rows``.

Unlike the reference, no hop overlaps its transfer with its tile: each
copy is issued after the hop's compute.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from repro_torch.core import morton, quadtree
from repro_torch.core.knn import key_low_words, write_keys
from repro_torch.core.summarize import summarize
from repro_torch.core.tsne import GradResult, TsneState, combine_forces, gd_move
from repro_torch.distributed.collectives import (  # noqa: F401  (re-exported)
    Mesh, all_gather, gather_rows, make_mesh, pmax, ppermute, psum, ring_permute, shard_rows,
)
from repro_torch.kernels import ops
from repro_torch.neighbors._candidates import candidate_sq_dists, merge_topk
from repro_torch.neighbors.rp_forest import (
    _draw_dirs, build_forest_index_with_draws, route_to_leaves,
)

# query rows a distance tile of ring_knn: bounds a hop's [rows, n_loc] tile
# and its int64 keys (the reference takes all of a shard's rows at once)
RING_BLOCK_ROWS = 4096
# ring_knn_approx: rank r draws its hyperplanes from seed + r * this prime,
# so shard 1's seed never collides with shard 0's tree-index folds
RANK_SEED_STRIDE = 7919


# ---------------------------------------------------------------------------
# sharded Barnes-Hut gradient
# ---------------------------------------------------------------------------

class LocalGradient(NamedTuple):
    """One shard's parts of the gradient: its rows' forces and its partial sums."""
    f_rep: torch.Tensor     # [n_loc, 2] unnormalised repulsion
    f_attr: torch.Tensor    # [n_loc, 2]
    z: torch.Tensor         # [] this shard's points' sum_j (1 + d^2)^-1
    kl_attr: torch.Tensor   # [] this shard's rows' sum p log(1 + d^2)


def local_bh_gradient(y_full: torch.Tensor, rank: int, n_loc: int, p_cols: torch.Tensor,
                      p_vals: torch.Tensor, p_len: torch.Tensor | None = None, *,
                      theta: float, depth: int = morton.DEFAULT_DEPTH) -> LocalGradient:
    """The per-shard body: the gradient's parts for rows ``rank * n_loc ..``
    of the global embedding ``y_full [N, 2]``; ``p_cols``, ``p_vals`` and
    ``p_len`` are those rows of the ELL graph (global column indices).

    Builds the replicated tree over all N points, walks this shard's
    points at their sorted positions (ascending, so a warp's lanes walk
    Morton neighbours; the rows are scattered back), and runs the
    attractive pass over its rows against the global y.  Each row's force
    is bit for bit the row :func:`core.tsne.bh_gradient` gives it."""
    n = y_full.shape[0]
    cent, r_span = morton.span_radius(y_full)
    codes = ops.morton_encode(y_full, cent, r_span, depth=depth)
    codes_s, y_s, perm = quadtree.sort_points_by_code(y_full, codes)
    tree = quadtree.build_quadtree(codes_s, depth=depth, compress=True)
    summ = summarize(tree, y_s, r_span)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=perm.device)
    pos, order = torch.sort(inv[rank * n_loc:(rank + 1) * n_loc])
    rep = ops.bh_traverse(y_s, tree, summ, theta, pos=pos.to(torch.int32))
    f_rep = torch.empty_like(rep.force)
    f_rep[order] = rep.force
    f_attr, kl_attr = ops.attractive_ell(y_full, p_cols, p_vals, p_len, row0=rank * n_loc)
    return LocalGradient(f_rep=f_rep, f_attr=f_attr, z=torch.sum(rep.z_per_point),
                         kl_attr=kl_attr)


def distributed_bh_gradient(mesh: Mesh, y, p_cols, p_vals, p_logp, *, theta: float,
                            exaggeration: float, depth: int = morton.DEFAULT_DEPTH,
                            p_len=None) -> GradResult:
    """y [N, 2], p_cols / p_vals [N, W] (and p_len [N], or None) sharded
    row-wise over ``mesh`` (lists of per-shard tensors).  Returns
    GradResult with ``grad`` the per-shard list and kl, z on rank 0's
    device (every rank holds the same bits); ``max_traversal`` 0, as the
    reference's."""
    n_loc = y[0].shape[0]
    y_full = all_gather(mesh, y)
    parts = [local_bh_gradient(y_full[r], r, n_loc, p_cols[r], p_vals[r],
                               None if p_len is None else p_len[r], theta=theta, depth=depth)
             for r in range(mesh.size)]
    z = psum(mesh, [g.z for g in parts])
    kl_attr = psum(mesh, [g.kl_attr for g in parts])
    res = [combine_forces(g.f_attr, kl_attr[r], g.f_rep, z[r], exaggeration,
                          p_logp.to(mesh.devices[r]) if torch.is_tensor(p_logp) else p_logp)
           for r, g in enumerate(parts)]
    return GradResult(grad=[r.grad for r in res], kl=res[0].kl, z=res[0].z,
                      max_traversal=res[0].max_traversal)


def gd_update_sharded(mesh: Mesh, states: Sequence[TsneState], grads, lr: float,
                      momentum: float, min_gain: float) -> list[TsneState]:
    """:func:`core.tsne.gd_update` on a sharded state: each shard moves its
    rows, then all re-centre on the mean over every shard (psum'd)."""
    moved = [gd_move(s, g, lr, momentum, min_gain) for s, g in zip(states, grads)]
    n = sum(m.y.shape[0] for m in moved)
    sums = psum(mesh, [torch.sum(m.y, dim=0, keepdim=True) for m in moved])
    return [m._replace(y=m.y - sums[r] / n) for r, m in enumerate(moved)]


# ---------------------------------------------------------------------------
# exact ring KNN
# ---------------------------------------------------------------------------

def _shard_size(x: Sequence[torch.Tensor]) -> int:
    n_loc = x[0].shape[0]
    if any(p.shape[0] != n_loc for p in x):
        raise ValueError(f"shards of unequal size: {[p.shape[0] for p in x]}")
    return n_loc


def ring_knn(mesh: Mesh, x: Sequence[torch.Tensor], k: int, *, n_valid: int | None = None):
    """Exact distributed KNN of x [N, D], sharded row-wise over ``mesh``.

    Returns (idx [N, k] int32 global indices, d2 [N, k]) sharded like x.
    Rows >= ``n_valid`` (default: none) are padding, never emitted.  At
    each hop every shard scores its queries against the visiting shard
    (the ``pairwise_sq_dists`` kernel), masks self and padding columns to
    ``finfo.max`` and merges with its running top-k as the reference's
    ``lax.top_k`` over ``[best | hop]`` does: among equal distances the
    earlier slot of that concatenation wins, the running best first.  The
    merge ranks (distance bits, slot) keys, so the indices are the
    reference's where the distances are (hops visit owners rank, rank - 1,
    ..., so equal distances are not in global index order)."""
    s = mesh.size
    n_loc = _shard_size(x)
    n_total = n_loc * s if n_valid is None else int(n_valid)
    big = torch.finfo(x[0].dtype).max
    sqn = [torch.sum(p * p, dim=1) for p in x]
    best_keys = []
    for r, dev in enumerate(mesh.devices):
        keys = torch.empty((n_loc, k), dtype=torch.int64, device=dev)
        write_keys(keys, torch.full((n_loc, k), big, dtype=x[r].dtype, device=dev),
                   torch.arange(k, dtype=torch.int32, device=dev))
        best_keys.append(keys)
    best_i = [torch.full((n_loc, k), -1, dtype=torch.int32, device=dev) for dev in mesh.devices]
    chunks, chunk_sqn = list(x), list(sqn)
    for t in range(s):
        for r, dev in enumerate(mesh.devices):
            owner = (r - t) % s
            col = torch.arange(owner * n_loc, (owner + 1) * n_loc, dtype=torch.int32,
                               device=dev)
            slots = torch.arange(k, k + n_loc, dtype=torch.int32, device=dev)
            for b0 in range(0, n_loc, RING_BLOCK_ROWS):
                b1 = min(b0 + RING_BLOCK_ROWS, n_loc)
                d2 = ops.pairwise_sq_dists(x[r][b0:b1], chunks[r], sqn[r][b0:b1], chunk_sqn[r])
                q_idx = torch.arange(r * n_loc + b0, r * n_loc + b1, dtype=torch.int32,
                                     device=dev)
                mask = (col[None, :] == q_idx[:, None]) | (col[None, :] >= n_total)
                keys = torch.empty((b1 - b0, k + n_loc), dtype=torch.int64, device=dev)
                keys[:, :k] = best_keys[r][b0:b1]
                # + 0.0: a -0.0 ties with +0.0, as the reference's comparison has it
                write_keys(keys[:, k:], d2.masked_fill(mask, big) + 0.0, slots)
                top = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
                slot = key_low_words(top)
                kept = torch.gather(best_i[r][b0:b1], 1, torch.clamp_max(slot, k - 1))
                best_i[r][b0:b1] = torch.where(slot < k, kept,
                                               (owner * n_loc + slot - k).to(torch.int32))
                # the kept slots renumbered 0..k-1: the next hop's best comes first
                words = top.view(torch.int32)
                words[:, 0::2] = torch.arange(k, dtype=torch.int32, device=dev)
                best_keys[r][b0:b1] = top
        chunks = ring_permute(mesh, chunks)
        chunk_sqn = ring_permute(mesh, chunk_sqn)
    d2 = [torch.clamp_min(kb.view(torch.int32)[:, 1::2].contiguous().view(x[0].dtype), 0.0)
          for kb in best_keys]
    return best_i, d2


# ---------------------------------------------------------------------------
# approximate candidate ring (sharded rp_forest)
# ---------------------------------------------------------------------------

def approx_forest_shape(n_loc: int, k: int, leaf_size: int) -> tuple[int, int]:
    """(depth, padded points) of a shard's forest: the deepest split keeping
    leaves >= max(leaf_size, k + 1) local points, as
    ``RPForestNeighbors.resolve_depth``."""
    leaf_floor = max(leaf_size, k + 1)
    depth = max(0, int(math.floor(math.log2(max(1.0, n_loc / leaf_floor)))))
    return depth, (-(-n_loc // (1 << depth))) << depth


def ring_knn_approx(mesh: Mesh, x: Sequence[torch.Tensor], k: int, *,
                    n_valid: int | None = None, n_trees: int = 8, leaf_size: int = 64,
                    block_rows: int = 4096, seed: int = 0):
    """Sharded approximate KNN: a per-shard rp_forest and the candidate ring.

    x [N, D] sharded row-wise over ``mesh``; rows >= ``n_valid`` are
    padding (scored as queries, never emitted).  Rank r draws its
    ``[n_trees, depth, D]`` hyperplanes from a CPU ``torch.Generator``
    seeded ``seed + r * 7919``, as the other forests draw; see
    :func:`ring_knn_approx_with_draws`.  Returns (idx [N, k] int32 global
    indices, d2 [N, k]) sharded like x."""
    n_loc, d = x[0].shape
    depth, _ = approx_forest_shape(n_loc, k, leaf_size)
    dirs = [_draw_dirs(torch.Generator().manual_seed(int(seed) + r * RANK_SEED_STRIDE),
                       n_trees, depth, d, x[r].dtype).to(dev)
            for r, dev in enumerate(mesh.devices)]
    return ring_knn_approx_with_draws(mesh, x, k, dirs, n_valid=n_valid, leaf_size=leaf_size,
                                      block_rows=block_rows)


def ring_knn_approx_with_draws(mesh: Mesh, x: Sequence[torch.Tensor], k: int,
                               dirs: Sequence[torch.Tensor], *, n_valid: int | None = None,
                               leaf_size: int = 64, block_rows: int = 4096):
    """:func:`ring_knn_approx` given each rank's hyperplanes ``dirs[r]
    [n_trees, depth, D]`` (depth as :func:`approx_forest_shape` gives it).

    Each query visits every shard once (S hops) and comes home with the
    merged global top-k.  At a hop the host shard routes each block of
    ``block_rows`` visiting queries down its forest, adds a seed block of
    its first k + 1 points (k distinct valid indices even if the forest's
    candidates collapse), scores them exactly, maps leaf padding and global
    padding ids to -1 and the query's own id to ``finfo.max``, and folds
    them into the travelling top-k (``merge_topk``, which drops the -1s)."""
    s = mesh.size
    n_loc = _shard_size(x)
    n_total = n_loc * s if n_valid is None else int(n_valid)
    if n_loc < k + 1:
        raise ValueError(f"shard size {n_loc} must exceed k={k}: lower the shard count")
    depth, n_pad_loc = approx_forest_shape(n_loc, k, leaf_size)
    if any(tuple(dr.shape[1:]) != (depth, x[0].shape[1]) for dr in dirs):
        raise ValueError(f"dirs: expected [n_trees, {depth}, {x[0].shape[1]}] a rank, got "
                         f"{[tuple(dr.shape) for dr in dirs]}")
    n_seed = min(k + 1, n_loc)
    block = min(block_rows, n_loc)
    m_pad = -(-n_loc // block) * block
    big = torch.finfo(x[0].dtype).max
    forests = [build_forest_index_with_draws(x[r], dirs[r], n_pad_loc) for r in range(s)]

    state = []                        # (queries, their global ids, best idx, best d2)
    for r, dev in enumerate(mesh.devices):
        q = torch.zeros((m_pad, x[r].shape[1]), dtype=x[r].dtype, device=dev)
        q[:n_loc] = x[r]
        gid = torch.full((m_pad,), -1, dtype=torch.int32, device=dev)
        gid[:n_loc] = torch.arange(r * n_loc, (r + 1) * n_loc, dtype=torch.int32, device=dev)
        state.append((q, gid, torch.full((m_pad, k), -1, dtype=torch.int32, device=dev),
                      torch.full((m_pad, k), big, dtype=x[r].dtype, device=dev)))
    for _ in range(s):
        for r, dev in enumerate(mesh.devices):
            leaves, dirs_r, thrs = forests[r]
            q, gid, bi, bd = state[r]
            base = r * n_loc                       # global id of local row 0
            seed_cols = torch.arange(n_seed, dtype=leaves.dtype, device=dev)[None, :]
            out_i, out_d = [], []
            for b0 in range(0, m_pad, block):
                qb, gb = q[b0:b0 + block], gid[b0:b0 + block]
                cand = route_to_leaves(leaves, dirs_r, thrs, qb)          # local ids
                cand = torch.cat([cand, seed_cols.expand(qb.shape[0], n_seed)], dim=1)
                cd = candidate_sq_dists(x[r], cand, block_rows=block, q=qb)
                cand_g = torch.where(cand < n_loc, base + cand, -1)
                cand_g = torch.where(cand_g < n_total, cand_g, -1)
                cd = cd.masked_fill(cand_g == gb[:, None], big)           # self edge
                mi, md = merge_topk(bi[b0:b0 + block], bd[b0:b0 + block], cand_g, cd, k,
                                    n_total, exclude_self=False)
                out_i.append(mi)
                out_d.append(md)
            state[r] = (q, gid, torch.cat(out_i), torch.cat(out_d))
        # the merged state travels on to the next shard's forest
        state = list(zip(*(ring_permute(mesh, part) for part in zip(*state))))
    return ([bi[:n_loc] for _, _, bi, _ in state],
            [torch.clamp_min(bd[:n_loc], 0.0) for _, _, _, bd in state])

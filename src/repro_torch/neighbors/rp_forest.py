"""Random-projection tree forest (Annoy / FIt-SNE-style approximate KNN):
port of ``repro/neighbors/rp_forest.py``.

Each tree halves the point set ``depth`` times with median hyperplane
splits: level ``l`` sorts each of the 2^l equal-length segments by the
points' projection on that level's random direction (a stable sort within
each segment, as the reference's two-key ``lax.sort`` of (segment,
projection)), and halving a sorted segment is a median split, so the tree
stays balanced.  Leaves then hold ``ceil(N / 2^depth)`` points; within
each leaf all pairs are scored exactly and the top-k kept, and the trees'
graphs are merged with duplicates dropped.  An optional ``refine_iters``
polish runs NN-descent over the forest's graph.

The same forest serves out-of-sample queries: the build records each
level's split threshold, so a new point routes down every tree (project,
compare, descend) to a leaf whose members are scored exactly and merged
across trees.

Random draws: the reference draws the hyperplanes from ``jax.random``,
which torch cannot repeat.  The ``*_with_draws`` functions and
:func:`build_tree` take their draws as tensors; the public functions draw
them from a CPU ``torch.Generator`` seeded with ``seed`` (hyperplanes
``[n_trees, depth, D]`` first, then the seed graph's offsets) and move
them to the points' device, so the card and the CPU get the same draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

from repro_torch.core.knn import key_low_words, write_keys
from repro_torch.neighbors._candidates import (
    candidate_sq_dists, draw_offsets, merge_topk, seed_graph,
)
from repro_torch.neighbors.base import (
    register_neighbor_backend, validate_k, validate_query_k,
)

# bytes of one leaf block's [L, S, S] int64 keys in leaf_topk
LEAF_BLOCK_BYTES = 1 << 30


def build_tree(x: torch.Tensor, dirs: torch.Tensor, n_pad: int):
    """One tree of hyperplanes ``dirs [depth, D]``: leaf membership and the
    split thresholds that route queries.

    Returns ``(leaves [2^depth, n_pad >> depth] int64 point indices (pads
    hold idx >= N), thrs)``, where ``thrs[l] [2^l]`` is the split value of
    each level-``l`` node: the midpoint of the two projections straddling
    the median (``inf`` where both are pads), so a query goes right iff its
    projection exceeds it.  Pads project to ``finfo.max`` and sink to the
    high side of every split.
    """
    n = x.shape[0]
    depth = dirs.shape[0]
    order = torch.arange(n_pad, dtype=torch.int64, device=x.device)
    thrs = []
    if depth:
        proj = x @ dirs.T                                   # [N, depth]
        big = torch.finfo(x.dtype).max
        for level in range(depth):
            seg_len = n_pad >> level
            p = torch.where(order < n, proj[torch.clamp(order, max=n - 1), level], big)
            p2, perm = torch.sort(p.view(1 << level, seg_len), dim=1, stable=True)
            order = torch.gather(order.view(1 << level, seg_len), 1, perm).view(-1)
            half = seg_len >> 1
            thrs.append(0.5 * (p2[:, half - 1] + p2[:, half]))
    return order.view(1 << depth, n_pad >> depth), tuple(thrs)


def leaf_topk(x: torch.Tensor, leaves: torch.Tensor, k: int, n_pad: int):
    """Exact top-k within each leaf, scattered per point.

    Returns ``(idx [n_pad, kk] int32, d2 [n_pad, kk])`` with
    ``kk = min(k, S - 1)``; rows >= N are pad slots the caller slices off.
    Equal distances keep their order of position in the leaf, as
    ``lax.top_k`` over the leaf's columns keeps them.
    """
    n = x.shape[0]
    n_leaves, s = leaves.shape
    kk = min(k, s - 1)
    big = torch.finfo(x.dtype).max
    dev = x.device
    out_i = torch.zeros((n_pad, kk), dtype=torch.int32, device=dev)
    out_d = torch.zeros((n_pad, kk), dtype=x.dtype, device=dev)
    self_col = torch.eye(s, dtype=torch.bool, device=dev)[None]
    col = torch.arange(s, dtype=torch.int32, device=dev)
    block = max(1, LEAF_BLOCK_BYTES // (8 * s * s))
    for l0 in range(0, n_leaves, block):
        lv = leaves[l0:l0 + block]
        xb = x[torch.clamp(lv, 0, n - 1)]                   # [L, S, D]
        sqn = torch.sum(xb * xb, dim=2)
        d2 = sqn[:, :, None] + sqn[:, None, :] - 2.0 * torch.bmm(xb, xb.transpose(1, 2))
        d2 = d2.masked_fill((lv >= n)[:, None, :] | self_col, big)
        keys = torch.empty(d2.shape, dtype=torch.int64, device=dev)
        write_keys(keys, d2 + 0.0, col)                     # -0.0 ties with +0.0
        pos = key_low_words(torch.topk(keys, kk, dim=2, largest=False, sorted=True).values)
        glob = torch.gather(lv[:, None, :].expand(-1, s, -1), 2, pos)
        rows = lv.reshape(-1)
        out_i[rows] = glob.reshape(-1, kk).to(torch.int32)
        out_d[rows] = torch.clamp_min(torch.gather(d2, 2, pos), 0.0).reshape(-1, kk)
    return out_i, out_d


def forest_shape(n: int, depth: int) -> tuple[int, int]:
    """(leaf size, padded point count) of a forest of ``depth`` levels."""
    leaf = -(-n // (1 << depth))                            # ceil(n / 2^depth)
    return leaf, leaf << depth


def _draw_dirs(gen: torch.Generator, n_trees: int, depth: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return torch.randn((n_trees, depth, d), generator=gen, dtype=dtype)


def rp_forest_knn(x: torch.Tensor, k: int, *, n_trees: int = 8, depth: int = 4,
                  seed: int = 0, block_rows: int = 512):
    """Approximate KNN via ``n_trees`` RP trees of ``depth`` median splits."""
    gen = torch.Generator().manual_seed(int(seed))
    dirs = _draw_dirs(gen, n_trees, depth, x.shape[1], x.dtype)
    offsets = draw_offsets(gen, x.shape[0], k)
    return rp_forest_knn_with_draws(x, k, dirs.to(x.device), offsets.to(x.device),
                                    block_rows=block_rows)


def rp_forest_knn_with_draws(x: torch.Tensor, k: int, dirs: torch.Tensor,
                             offsets: torch.Tensor, block_rows: int = 512):
    """:func:`rp_forest_knn` given its draws: the trees' hyperplanes
    ``dirs [n_trees, depth, D]`` and the seed graph's ``offsets [k]``."""
    n = x.shape[0]
    _, n_pad = forest_shape(n, dirs.shape[1])
    best_i, best_d = seed_graph(x, offsets, block_rows=block_rows)
    # collect every tree's within-leaf top-k, then fold once: one wide
    # dedup/top-k merge, as the reference does
    cand_i, cand_d = [], []
    for tree_dirs in dirs:
        leaves, _ = build_tree(x, tree_dirs, n_pad)
        ti, td = leaf_topk(x, leaves, k, n_pad)
        cand_i.append(ti[:n])
        cand_d.append(td[:n])
    return merge_topk(best_i, best_d, torch.cat(cand_i, dim=1), torch.cat(cand_d, dim=1),
                      k, n)


def build_forest_index(x: torch.Tensor, n_trees: int, depth: int, n_pad: int,
                       seed: int = 0):
    """Every tree's routing structure: the frozen query-side forest.

    The hyperplanes are drawn as :func:`rp_forest_knn` draws them (same
    generator, same order), so at the same depth the queries descend the
    trees the fitted points were bucketed by.  Returns what
    :func:`build_forest_index_with_draws` returns.
    """
    gen = torch.Generator().manual_seed(int(seed))
    dirs = _draw_dirs(gen, n_trees, depth, x.shape[1], x.dtype)
    return build_forest_index_with_draws(x, dirs.to(x.device), n_pad)


def build_forest_index_with_draws(x: torch.Tensor, dirs: torch.Tensor, n_pad: int):
    """``(leaves [T, 2^depth, leaf_size], dirs [T, depth, D], thrs)`` with
    ``thrs[l] [T, 2^l]``, given the hyperplanes ``dirs``."""
    leaves, thrs = zip(*(build_tree(x, tree_dirs, n_pad) for tree_dirs in dirs))
    depth = dirs.shape[1]
    return (torch.stack(leaves), dirs,
            tuple(torch.stack([th[level] for th in thrs]) for level in range(depth)))


def route_to_leaves(leaves: torch.Tensor, dirs: torch.Tensor, thrs, q: torch.Tensor):
    """Descend every tree with each query point; gather its leaf's members.

    q [M, D] -> cand [M, n_trees * leaf_size] reference-set indices (entries
    >= the fitted N are leaf padding the caller must mask).
    """
    n_trees, _, leaf_size = leaves.shape
    depth = dirs.shape[1]
    m = q.shape[0]
    tree_ids = torch.arange(n_trees, device=q.device)[None, :]          # [1, T]
    node = torch.zeros((m, n_trees), dtype=torch.int64, device=q.device)
    if depth:
        proj = torch.einsum("md,tld->mtl", q, dirs)                     # [M, T, depth]
        for level in range(depth):
            thr = thrs[level][tree_ids, node]                           # [M, T]
            node = node * 2 + (proj[:, :, level] > thr).long()
    return leaves[tree_ids, node].reshape(m, n_trees * leaf_size)


def forest_query(x_ref: torch.Tensor, leaves: torch.Tensor, dirs: torch.Tensor, thrs,
                 q: torch.Tensor, k: int, block_rows: int = 512):
    """Route queries down every tree, score leaf members exactly, merge.

    q [M, D] -> (idx [M, k] into x_ref, d2 [M, k]).  A deterministic seed
    row (the first k reference points, scored exactly) guarantees k valid
    distinct indices even if the forest's candidates collapse to duplicates.
    """
    n = x_ref.shape[0]
    m = q.shape[0]
    cand = route_to_leaves(leaves, dirs, thrs, q)
    cd = candidate_sq_dists(x_ref, cand, block_rows=block_rows, q=q)
    base_i = torch.arange(k, dtype=torch.int32, device=q.device)[None].expand(m, k)
    base_d = candidate_sq_dists(x_ref, base_i, block_rows=block_rows, q=q)
    return merge_topk(base_i, base_d, cand, cd, k, n, exclude_self=False)


@dataclasses.dataclass(frozen=True, eq=False)
class RPForestIndex:
    """Frozen RP forest over a fitted reference set, ready for queries."""

    x_ref: torch.Tensor
    leaves: torch.Tensor                   # [T, 2^depth, leaf_size]
    dirs: torch.Tensor                     # [T, depth, D]
    thrs: tuple                            # level l: [T, 2^l]
    block_rows: int = 512

    @property
    def n_reference(self) -> int:
        return int(self.x_ref.shape[0])

    def query(self, x_new: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        validate_query_k(self.n_reference, k)
        return forest_query(self.x_ref, self.leaves, self.dirs, self.thrs,
                            x_new.to(self.x_ref.dtype), k, block_rows=self.block_rows)


@dataclasses.dataclass(frozen=True)
class RPForestNeighbors:
    """Forest of random-projection trees; ``refine_iters`` adds NN-descent
    polish passes over the forest's graph (see ``nn_descent.py``)."""

    name: ClassVar[str] = "rp_forest"
    n_trees: int = 8
    leaf_size: int = 64
    refine_iters: int = 2
    seed: int = 0
    block_rows: int = 512

    def resolve_depth(self, n: int, k: int) -> int:
        """Deepest split keeping leaves >= max(leaf_size, k+1) points, so a
        single leaf can supply a full top-k row."""
        leaf = max(self.leaf_size, k + 1)
        return max(0, int(math.floor(math.log2(max(1.0, n / leaf)))))

    def neighbors(self, x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        validate_k(x.shape[0], k)
        idx, d2 = rp_forest_knn(x, k, n_trees=self.n_trees,
                                depth=self.resolve_depth(x.shape[0], k),
                                seed=self.seed, block_rows=self.block_rows)
        if self.refine_iters > 0:
            from repro_torch.neighbors.nn_descent import nn_descent_knn
            # offset the seed, as the reference does: refine rounds must not
            # replay the draws of the tree hyperplanes
            idx, d2 = nn_descent_knn(x, k, init=(idx, d2), n_iters=self.refine_iters,
                                     seed=self.seed + 1, block_rows=self.block_rows)
        return idx, d2

    def build_index(self, x: torch.Tensor) -> RPForestIndex:
        """Build (once) the forest a fitted reference set is bucketed by.

        Depth follows the ``neighbors`` heuristic with ``k = leaf_size - 1``
        so leaves keep >= ``leaf_size`` points whatever the later query k;
        ``validate_query_k`` bounds k at query time.
        """
        n = int(x.shape[0])
        depth = self.resolve_depth(n, max(1, min(self.leaf_size, n) - 1))
        _, n_pad = forest_shape(n, depth)
        leaves, dirs, thrs = build_forest_index(x, self.n_trees, depth, n_pad, seed=self.seed)
        return RPForestIndex(x_ref=x, leaves=leaves, dirs=dirs, thrs=thrs,
                             block_rows=self.block_rows)


register_neighbor_backend("rp_forest", RPForestNeighbors)

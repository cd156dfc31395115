"""NN-descent: iterative neighbor-of-neighbor graph refinement (Dong et al.):
port of ``repro/neighbors/nn_descent.py``.

"A neighbor of my neighbor is probably my neighbor", as a fixed-width
loop: every round samples ``n_sample`` columns of the current graph,
expands them one hop forward (``idx[idx]``), scatters a bounded sample of
reverse edges, scores all candidates exactly, and folds them into the
running top-k (:func:`merge_topk`).  Usable standalone from a random seed
graph or as a polish pass over ``rp_forest`` output (``init=``).

Random draws: :func:`nn_descent_round` takes a round's draws as tensors;
:func:`nn_descent_knn` draws them from a CPU ``torch.Generator`` seeded
with ``seed`` (the seed graph's offsets first when there is no ``init``,
then each round's ``samp_pos``, ``hop2`` and ``slots``) and moves them to
the points' device, so the card and the CPU get the same draws.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch.neighbors._candidates import (
    candidate_sq_dists, draw_offsets, merge_topk, seed_graph,
)
from repro_torch.neighbors.base import register_neighbor_backend, validate_k


def nn_descent_round(x: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                     samp_pos: torch.Tensor, hop2: torch.Tensor, slots: torch.Tensor,
                     n_reverse: int, block_rows: int = 512):
    """One round over the graph ``(idx [N, k], d2 [N, k])`` given its draws:
    ``samp_pos [N, s]`` (the sampled columns of each row), ``hop2 [N, s]``
    (the second hop's columns) and ``slots [N, s]`` in ``[0, n_reverse)``
    (where each sampled edge writes its reverse edge).  Returns the new
    graph."""
    n, k = idx.shape
    s = samp_pos.shape[1]
    samp = torch.gather(idx, 1, samp_pos.long()).long()             # [N, s] sampled neighbors
    fwd = idx[samp[:, :, None], hop2.long()[:, None, :]].reshape(n, s * s)
    # bounded reverse-edge sample: each sampled edge i -> samp[i, j]
    # nominates i as a candidate of samp[i, j].  Of colliding writes the
    # reference (XLA on the CPU, which applies them in order) keeps the
    # largest row; amax is that, and deterministic on the card
    rows = torch.arange(n, dtype=torch.int64, device=x.device)[:, None].expand(n, s)
    rev = torch.full((n * n_reverse,), -1, dtype=torch.int64, device=x.device)
    rev.scatter_reduce_(0, (samp * n_reverse + slots.long()).reshape(-1), rows.reshape(-1),
                        reduce="amax")
    cand = torch.cat([fwd, rev.view(n, n_reverse).to(idx.dtype)], dim=1)
    cd = candidate_sq_dists(x, cand, block_rows=block_rows)
    return merge_topk(idx, d2, cand, cd, k, n)


def nn_descent_knn(x: torch.Tensor, k: int, *, init=None, n_iters: int = 10,
                   n_sample: int = 12, n_reverse: int = 12, seed: int = 0,
                   block_rows: int = 512):
    """Refine a KNN graph for ``n_iters`` rounds; ``init=None`` starts random.

    Candidate width per round is ``n_sample^2 + n_reverse``, so the cost is
    O(N n_iters n_sample^2 D) whatever k.
    """
    n = x.shape[0]
    dev = x.device
    gen = torch.Generator().manual_seed(int(seed))
    if init is None:
        idx, d2 = seed_graph(x, draw_offsets(gen, n, k), block_rows=block_rows)
    else:
        idx, d2 = init
    s = min(n_sample, k)
    for _ in range(n_iters):
        samp_pos, hop2, slots = (
            torch.randint(0, hi, (n, s), generator=gen, dtype=torch.int32).to(dev)
            for hi in (k, k, n_reverse))
        idx, d2 = nn_descent_round(x, idx, d2, samp_pos, hop2, slots, n_reverse,
                                   block_rows=block_rows)
    return idx, d2


@dataclasses.dataclass(frozen=True)
class NNDescentNeighbors:
    """Fixed-width NN-descent from a random seed graph."""

    name: ClassVar[str] = "nn_descent"
    n_iters: int = 10
    n_sample: int = 12
    n_reverse: int = 12
    seed: int = 0
    block_rows: int = 512

    def neighbors(self, x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        validate_k(x.shape[0], k)
        return nn_descent_knn(x, k, n_iters=self.n_iters, n_sample=self.n_sample,
                              n_reverse=self.n_reverse, seed=self.seed,
                              block_rows=self.block_rows)

    def build_index(self, x: torch.Tensor):
        """Out-of-sample queries fall back to the exact blocked scan: the
        refinement leaves no frozen routing structure a new point could
        descend (unlike the forest's hyperplanes)."""
        from repro_torch.neighbors.exact import ExactNeighbors
        return ExactNeighbors(block_db=self.block_rows * 4).build_index(x)


register_neighbor_backend("nn_descent", NNDescentNeighbors)

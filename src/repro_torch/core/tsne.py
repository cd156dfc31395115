"""End-to-end Barnes-Hut t-SNE pipeline (paper Fig. 1a): port of ``repro/core/tsne.py``.

Pipeline:  KNN -> BSP -> symmetrize P -> gradient descent, where every
iteration evaluates the attractive (sparse) + repulsive forces through a
pluggable gradient backend (Barnes-Hut by default; exact and FFT in
``repro_torch.api.backends``), with early exaggeration, momentum
switching and per-dimension gains as in the reference.  PyTorch runs
eagerly: there is no ``jit``, and the device is read only at the
``kl_every`` checkpoints.

Device: :func:`run_tsne` takes an explicit ``device`` (``None`` = cuda).
On a CUDA device the KNN tile, the perplexity search, the Morton codes,
the attractive forces and the FFT backend's spread and gather go through
the hand-written kernels of ``repro_torch.kernels``; on the CPU through
their plain twins.  The config keeps ``use_pallas`` / ``bsp_impl`` /
``attractive_impl`` so that a JAX config carries across, but none of them
routes around a kernel.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.core import attractive, bsp, morton, quadtree, similarity
from repro_torch.core.repulsive import bh_repulsion_sorted
from repro_torch.core.summarize import summarize
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

DEFAULT_ATTRACTIVE_IMPL = "blocked"

# Hard cap on the neighbor width K (the reference's envelope; the BSP
# kernel holds a row of up to 1024 values in one warp's registers).
MAX_N_NEIGHBORS = 1024

BSP_IMPLS = ("auto", "xla", "pallas")


@dataclasses.dataclass(frozen=True)
class TsneConfig:
    perplexity: float = 30.0
    n_iter: int = 1000
    theta: float = 0.5
    learning_rate: float | str = "auto"   # 'auto' = max(N / early_exaggeration, 50)
    early_exaggeration: float = 12.0
    exaggeration_iters: int = 250
    momentum_initial: float = 0.5
    momentum_final: float = 0.8
    momentum_switch_iter: int = 250
    min_gain: float = 0.01
    min_grad_norm: float = 1e-7           # early stop when ||grad|| drops below
    init_std: float = 1e-4
    depth: int | str = morton.DEFAULT_DEPTH   # "auto" = morton.auto_depth(N)
    seed: int = 0
    dtype: Any = torch.float32
    n_neighbors: int | None = None        # None = int(3 * perplexity); clamped to n-1
    neighbor_method: str = "exact"
    neighbor_options: Mapping[str, Any] | tuple | None = None
    knn_block_q: int = 512
    knn_block_db: int = 2048
    # rows per preprocessing slice for BSP and symmetrization (None = whole)
    chunk_size: int | None = None
    # kept so a JAX config carries across; the tensor's device, not these
    # flags, picks kernel or plain version
    use_pallas: bool = False
    bsp_impl: str = "auto"
    # 'ell' | 'components' | 'blocked' all name the one ELL attractive
    # kernel; 'edges' uses the directed edge list
    attractive_impl: str = DEFAULT_ATTRACTIVE_IMPL
    compress_tree: bool = True            # False = daal4py-like uncompressed tree
    method: str = "barnes_hut"            # registered gradient backend name
    fft_n_boxes: int = 48                 # grid boxes/dim for the 'fft' backend

    def __post_init__(self):
        if isinstance(self.neighbor_options, Mapping):
            object.__setattr__(self, "neighbor_options",
                               tuple(sorted(self.neighbor_options.items())))
        if self.bsp_impl not in BSP_IMPLS:
            raise ValueError(f"unknown bsp_impl {self.bsp_impl!r} "
                             f"(known: {', '.join(BSP_IMPLS)})")

    def resolve_lr(self, n: int) -> float:
        if self.learning_rate == "auto":
            return max(n / self.early_exaggeration, 50.0)
        return float(self.learning_rate)

    def resolve_n_neighbors(self, n: int) -> int:
        k = int(3.0 * self.perplexity) if self.n_neighbors is None \
            else int(self.n_neighbors)
        return max(1, min(k, n - 1, MAX_N_NEIGHBORS))

    def resolve_neighbor_options(self) -> dict:
        opts = dict(self.neighbor_options or {})
        if self.neighbor_method == "exact":
            opts.setdefault("block_q", self.knn_block_q)
            opts.setdefault("block_db", self.knn_block_db)
        return opts

    def resolve_chunk_size(self, n: int) -> int | None:
        if self.chunk_size is None:
            return None
        return max(1, min(int(self.chunk_size), n))

    def resolve_depth(self, n: int) -> int:
        return morton.auto_depth(n) if self.depth == "auto" else int(self.depth)


class TsneState(NamedTuple):
    y: torch.Tensor
    velocity: torch.Tensor
    gains: torch.Tensor
    iteration: int


class GradResult(NamedTuple):
    """Common product of every gradient backend (exact / barnes_hut / fft)."""
    grad: torch.Tensor
    kl: torch.Tensor          # KL(P||Q) estimate (exact attractive part, backend Z)
    z: torch.Tensor
    max_traversal: torch.Tensor  # BH tree-walk length; 0 for tree-free backends


@dataclasses.dataclass(frozen=True)
class NeighborGraph:
    """Sparse symmetric input-similarity graph produced by :func:`preprocess`."""
    p_cols: torch.Tensor     # [N, W] int32 ELL neighbor indices (pad: row idx)
    p_vals: torch.Tensor     # [N, W] symmetric p_ij, sums to 1 (pad: 0)
    p_len: torch.Tensor      # [N] int32 real entries of each row (the rest pads)
    edge_src: torch.Tensor   # [NK] directed KNN edges ([1] dummy when unused)
    edge_dst: torch.Tensor
    edge_w: torch.Tensor     # p_{dst|src} / 2N
    p_logp: torch.Tensor     # exact sum_ij p_ij log p_ij (KL constant)
    n: int = 0
    has_edges: bool = False

    @property
    def edges(self):
        return (self.edge_src, self.edge_dst, self.edge_w) if self.has_edges else None


def combine_forces(f_attr, kl_attr, f_rep_unnorm, z, exaggeration, p_logp,
                   max_traversal=None) -> GradResult:
    """Shared backend epilogue (eq. 6/7).

    grad = 4 (exag * F_attr - F_rep / Z);  KL = sum p log p + kl_attr + log Z.
    """
    z = torch.clamp_min(z, 1e-30)
    grad = 4.0 * (exaggeration * f_attr - f_rep_unnorm / z)
    kl = p_logp + kl_attr + torch.log(z)
    if max_traversal is None:
        max_traversal = torch.zeros((), dtype=torch.int64, device=f_attr.device)
    return GradResult(grad=grad, kl=kl, z=z, max_traversal=max_traversal)


# ---------------------------------------------------------------------------
# One BH gradient evaluation (steps 3-6 of Fig. 1a)
# ---------------------------------------------------------------------------

def bh_gradient(y, p_cols, p_vals, edges, theta: float, exaggeration: float,
                depth: int, p_logp, compress_tree: bool = True,
                attractive_impl: str = DEFAULT_ATTRACTIVE_IMPL,
                p_len=None) -> GradResult:
    # --- quadtree building (step 3) ---
    cent, r_span = morton.span_radius(y)
    codes = ops.morton_encode(y, cent, r_span, depth=depth)
    codes_s, y_s, perm = quadtree.sort_points_by_code(y, codes)
    tree = quadtree.build_quadtree(codes_s, depth=depth, compress=compress_tree)
    # --- summarization (step 4) ---
    summ = summarize(tree, y_s, r_span)
    # --- repulsive (step 6) ---
    rep = bh_repulsion_sorted(y_s, tree, summ, theta)
    z = torch.sum(rep.z_per_point)
    f_rep = torch.empty_like(y)
    f_rep[perm] = rep.force
    # --- attractive (step 5) ---
    if edges is not None:
        f_attr, kl_attr = attractive.attractive_forces_edges(y, *edges)
    else:
        f_attr, kl_attr = attractive.ell_forces(attractive_impl)(y, p_cols, p_vals, p_len)
    return combine_forces(f_attr, kl_attr, f_rep, z, exaggeration, p_logp,
                          max_traversal=torch.max(rep.steps))


# ---------------------------------------------------------------------------
# Gradient-descent update (momentum + gains, scikit-learn/daal4py-compatible)
# ---------------------------------------------------------------------------

def gd_update(state: TsneState, grad, lr: float, momentum: float,
              min_gain: float) -> TsneState:
    same_sign = (grad > 0) == (state.velocity > 0)
    gains = torch.where(same_sign, state.gains * 0.8, state.gains + 0.2)
    gains = torch.clamp_min(gains, min_gain)
    velocity = momentum * state.velocity - lr * gains * grad
    y = state.y + velocity
    y = y - torch.mean(y, dim=0, keepdim=True)
    return TsneState(y=y, velocity=velocity, gains=gains,
                     iteration=state.iteration + 1)


class StepStats(NamedTuple):
    """Device-side per-iteration diagnostics returned by :func:`tsne_step`."""
    kl: torch.Tensor
    grad_norm: torch.Tensor
    z: torch.Tensor
    max_traversal: torch.Tensor


def tsne_step(state: TsneState, graph: NeighborGraph, exaggeration: float,
              momentum: float, *, backend, lr: float, min_gain: float):
    """One descent iteration: backend gradient + momentum/gains update."""
    res = backend.gradient(state.y, graph, exaggeration)
    grad_norm = torch.linalg.norm(res.grad)
    new_state = gd_update(state, res.grad, lr, momentum, min_gain)
    return new_state, StepStats(kl=res.kl, grad_norm=grad_norm, z=res.z,
                                max_traversal=res.max_traversal)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

class TsneResult(NamedTuple):
    y: np.ndarray
    kl: float
    kl_history: np.ndarray
    timings: dict
    n_iter: int = 0
    graph: "NeighborGraph | None" = None


@dataclasses.dataclass(frozen=True)
class IterationStats:
    """Structured observer payload, as in the reference."""
    iteration: int          # 1-based iteration just completed
    kl: float
    grad_norm: float
    z: float
    max_traversal: int      # longest BH tree walk (0 for exact)
    exaggeration: float
    momentum: float
    elapsed_s: float        # wall time since gradient descent started


ObserverFn = Callable[[IterationStats], None]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _phase(timings: dict, name: str, device: torch.device):
    """Seconds of one phase into ``timings[name]``, the device synchronised
    at both ends so that queued kernels are charged to their phase."""
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    timings[name] = time.perf_counter() - t0


def preprocess(x: torch.Tensor, config: TsneConfig) -> tuple[NeighborGraph, dict]:
    """KNN + BSP + symmetrization -> (NeighborGraph, stage timings), on x's device."""
    from repro_torch.neighbors import make_neighbor_backend   # lazy: builds on core
    dev = x.device
    n = int(x.shape[0])
    k = config.resolve_n_neighbors(n)
    nb = make_neighbor_backend(config.neighbor_method,
                               config.resolve_neighbor_options())
    timings: dict = {}
    with _phase(timings, "knn", dev):
        idx, d2 = nb.neighbors(x.to(config.dtype), k)

    chunk = config.resolve_chunk_size(n)
    with _phase(timings, "bsp", dev):
        if chunk is not None:
            cond_p, _ = bsp.binary_search_perplexity_chunked(d2, config.perplexity, chunk)
        else:
            cond_p, _ = bsp.binary_search_perplexity(d2, config.perplexity)

    with _phase(timings, "symmetrize", dev):
        if config.attractive_impl == "edges":
            # edge layout: only the directed edge list ships; the exact KL
            # constant comes from an ordered-pair dedup
            src, dst, w = similarity.edge_list(idx, cond_p)
            s = src.cpu().numpy().astype(np.int64)
            d = dst.cpu().numpy().astype(np.int64)
            wv = w.cpu().numpy().astype(np.float64)
            key = np.concatenate([s * n + d, d * n + s])
            _, inv = np.unique(key, return_inverse=True)
            p = np.bincount(inv, weights=np.concatenate([wv, wv]))
            p = p / p.sum()
            p_logp = float((p[p > 0] * np.log(p[p > 0])).sum())
            has_edges = True
            p_cols = torch.zeros((1, 1), dtype=torch.int32, device=dev)
            p_vals = torch.zeros((1, 1), dtype=config.dtype, device=dev)
            p_len = torch.zeros((1,), dtype=torch.int32, device=dev)
        else:
            idx_h, cond_h = idx.cpu().numpy(), cond_p.cpu().numpy()
            if chunk is not None:
                sym_cols, sym_vals = similarity.symmetrize_ell_chunked(idx_h, cond_h, chunk)
            else:
                sym_cols, sym_vals = similarity.symmetrize_ell(idx_h, cond_h)
            sym_vals = sym_vals / sym_vals.sum()
            lengths = similarity.ell_row_lengths(sym_cols)
            if (lengths != (sym_cols != np.arange(n)[:, None]).sum(axis=1)).any():
                raise RuntimeError("symmetrized ELL rows must hold their padding "
                                   "(col = row) after all real entries")
            pv = sym_vals[sym_vals > 0]
            p_logp = float((pv * np.log(pv)).sum())
            src = dst = torch.zeros((1,), dtype=torch.int32, device=dev)
            w = torch.zeros((1,), dtype=config.dtype, device=dev)
            has_edges = False
            p_cols = torch.as_tensor(sym_cols, device=dev)
            p_vals = torch.as_tensor(sym_vals, device=dev).to(config.dtype)
            p_len = torch.as_tensor(lengths, device=dev)
        graph = NeighborGraph(
            p_cols=p_cols, p_vals=p_vals, p_len=p_len, edge_src=src, edge_dst=dst, edge_w=w,
            p_logp=torch.tensor(p_logp, dtype=config.dtype, device=dev),
            n=n, has_edges=has_edges)
    timings.update(neighbor_method=nb.name, n_neighbors=k,
                   bsp_impl=config.bsp_impl, chunk_size=chunk,
                   knn_mean_d2=float(torch.mean(d2)))
    return graph, timings


def init_state(n: int, config: TsneConfig, device=None, y0=None) -> TsneState:
    """Initial descent state.  ``y0`` (any array-like [n, 2]) is used as
    given; without it y is drawn from a ``torch.Generator`` seeded with
    ``config.seed`` (torch cannot reproduce ``jax.random.normal``)."""
    dev = resolve_device(device)
    if y0 is not None:
        y = torch.tensor(np.asarray(y0), dtype=config.dtype, device=dev)
        if y.shape != (n, 2):
            raise ValueError(f"y0 must be [{n}, 2], got {tuple(y.shape)}")
    else:
        gen = torch.Generator().manual_seed(int(config.seed))
        y = (config.init_std * torch.randn((n, 2), generator=gen,
                                           dtype=config.dtype)).to(dev)
    return TsneState(y=y, velocity=torch.zeros_like(y), gains=torch.ones_like(y),
                     iteration=0)


def run_tsne(x, config: TsneConfig = TsneConfig(), observer: ObserverFn | None = None,
             kl_every: int = 50, backend=None, device=None, y0=None) -> TsneResult:
    """Full t-SNE run through a pluggable gradient backend on ``device``.

    ``backend`` defaults to the registered backend named ``config.method``.
    ``observer`` gets :class:`IterationStats` every ``kl_every`` iterations
    (and on the final one); ``config.min_grad_norm`` stops the descent early
    at those checkpoints.  ``y0`` replaces the random initial embedding.
    The timings dict holds per-phase seconds (knn, bsp, symmetrize,
    gradient_descent), each measured with the device synchronised.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x), dtype=config.dtype).to(dev)
    n = x.shape[0]
    lr = config.resolve_lr(n)
    graph, timings = preprocess(x, config)
    state = init_state(n, config, dev, y0)
    if backend is None:
        from repro_torch.api.backends import make_backend   # lazy: api builds on core
        backend = make_backend(config.method, config, n)

    with _phase(timings, "gradient_descent", dev):
        state, kl, kl_hist, n_run = descend(state, graph, config, backend, lr,
                                            observer, kl_every)
    return TsneResult(
        y=state.y.cpu().numpy(),
        kl=kl,
        kl_history=np.asarray(kl_hist, np.float64) if kl_hist else np.zeros((0, 2)),
        timings=timings,
        n_iter=n_run,
        graph=graph,
    )


def descend(state: TsneState, graph: NeighborGraph, config: TsneConfig, backend,
            lr: float, observer: ObserverFn | None = None, kl_every: int = 50):
    """The gradient descent of :func:`run_tsne` from ``state``: the
    exaggeration and momentum schedules of ``config``, KL read every
    ``kl_every`` iterations (and on the last), early stop on
    ``config.min_grad_norm`` there.  Returns (final state, last KL, KL
    history [(iteration, KL)], iterations run)."""
    kl_hist = []
    kl = float("nan")
    it = 0
    t0 = time.perf_counter()
    for it in range(config.n_iter):
        exag = config.early_exaggeration if it < config.exaggeration_iters else 1.0
        mom = config.momentum_initial if it < config.momentum_switch_iter \
            else config.momentum_final
        state, stats = tsne_step(state, graph, exag, mom, backend=backend,
                                 lr=lr, min_gain=config.min_gain)
        if (it + 1) % kl_every == 0 or it == config.n_iter - 1:
            kl = float(stats.kl)
            grad_norm = float(stats.grad_norm)
            kl_hist.append((it + 1, kl))
            if observer is not None:
                observer(IterationStats(
                    iteration=it + 1, kl=kl, grad_norm=grad_norm,
                    z=float(stats.z), max_traversal=int(stats.max_traversal),
                    exaggeration=exag, momentum=mom,
                    elapsed_s=time.perf_counter() - t0))
            if grad_norm < config.min_grad_norm:
                break
    return state, kl, kl_hist, it + 1

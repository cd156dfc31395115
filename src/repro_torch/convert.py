"""The state that crosses between ``repro`` and ``repro_torch``, from numpy.

t-SNE has no weights.  What one package's run hands the other is the
fitted sparse input-similarity graph, the descent state (whole, or split
over a device mesh by :func:`shard_state`) and a fitted random-projection
forest.  The LM substrate does have weights: :func:`lm_params_from_numpy`
carries a model's parameter tree across (any family, whisper's encoder
among the stacks; and :func:`lm_params_to_numpy` back),
:func:`adamw_state_from_numpy` its optimizer state and
:func:`kv_cache_from_numpy` its stacked KV, latent, recurrent or
self-and-cross cache.
Everything crosses as numpy arrays (never framework objects), so this module needs nothing of
the JAX package.  The LM functions import the LM package when called: the
t-SNE half does not load it.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core.similarity import ell_row_lengths
from repro_torch.core.tsne import NeighborGraph, TsneState
from repro_torch.device import resolve_device
from repro_torch.neighbors.rp_forest import RPForestIndex
from repro_torch.tree import tree_leaves_with_path, tree_map, tree_unflatten_like

if TYPE_CHECKING:
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.model import DecoderLM
    from repro_torch.train.optimizer import AdamWState


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


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array on ``device`` with its dtype; bfloat16 arrays (JAX's
    ``ml_dtypes`` type, which torch cannot read) cross through their bits."""
    a = np.array(a)                                # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


# leaves the reference's init stores in float32 whatever param_dtype is:
# RWKV's decay base and bonus, Mamba's dt bias, A and skip
FLOAT32_LEAVES = ("w0", "u", "dt_bias", "a_log", "d_skip")


def _leaf_dtypes(cfg: ArchConfig, tree):
    """Each leaf's parameter dtype as the reference's init gives it:
    ``cfg.param_dtype``, except the MoE router's ``w`` and ``bias`` and
    :data:`FLOAT32_LEAVES`, which are float32 whatever ``param_dtype`` is."""
    pd = cfg.pdtype()
    return tree_unflatten_like(tree, [
        torch.float32 if "router" in path or path[-1] in FLOAT32_LEAVES else pd
        for path, _ in tree_leaves_with_path(tree)])


def lm_params_from_numpy(cfg: ArchConfig, tree, *, device=None) -> DecoderLM:
    """A decoder's parameters (:class:`~repro_torch.models.model.DecoderLM`)
    from the reference's parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``), each leaf cast to its
    reference dtype (``cfg.param_dtype``; the MoE router and
    :data:`FLOAT32_LEAVES` float32).

    Weights keep the reference's ``[in, out]`` layout (the port computes
    ``x @ w``, as the reference does), so nothing is transposed.  Each
    layer stack (``layers``, the MoE family's ``dense_layers``, the audio
    family's ``encoder``, the hybrid family's ``layers/mamba``) may be the
    scanned layout (a dict whose leaves are stacked ``[L, ...]``,
    ``scan_layers=True`` and always for the ssm and hybrid families) or a
    list of block dicts."""
    from repro_torch.models.model import DecoderLM, layer_stacks, tree_get, tree_put
    dev = resolve_device(device)
    tree = tree_map(lambda a: a, tree)              # the containers copied, not the leaves
    for path, depth in layer_stacks(cfg).items():
        layers = tree_get(tree, path)
        if isinstance(layers, dict):
            layers = [tree_map(lambda a, i=i: np.asarray(a)[i], layers) for i in range(depth)]
        if len(layers) != depth:
            raise ValueError(f"{len(layers)} {'/'.join(path)} in the tree, {depth} in "
                             f"{cfg.name}")
        tree_put(tree, path, list(layers))
    return DecoderLM(cfg, tree_map(lambda a, dt: _tensor(a, dev).to(dt), tree,
                                   _leaf_dtypes(cfg, tree)))


def lm_params_to_numpy(params: DecoderLM, stacked: bool = True) -> dict:
    """The reference's parameter tree (``jax.tree.map(np.asarray, params)``'s
    form) from a :class:`~repro_torch.models.model.DecoderLM`: each layer
    stack a block dict of stacked ``[L, ...]`` arrays
    (``scan_layers=True``; always for the ssm and hybrid families, which
    have no other layout), or the list of block dicts.  Copied to the
    host, then stacked there; bfloat16 parameters come back as float32
    arrays (exact: numpy has no bfloat16)."""
    from repro_torch.models.model import layer_stacks, tree_get, tree_put

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    tree = tree_map(host, params.tree())
    if stacked or params.cfg.family in ("ssm", "hybrid"):
        for path in layer_stacks(params.cfg):
            tree_put(tree, path, tree_map(lambda *a: np.stack(a), *tree_get(tree, path)))
    return tree


def adamw_state_from_numpy(cfg: ArchConfig, state, *, device=None) -> AdamWState:
    """The port's :class:`~repro_torch.train.optimizer.AdamWState` from the
    reference's (its fields as numpy arrays, ``jax.tree.map(np.asarray,
    state)``): the step as an int, ``m`` and ``v`` in their own dtypes
    (bfloat16 by its bits) and structure (factored ``{row, col}`` dicts
    kept).  The layers' layout must be ``cfg``'s: stacked ``[L, ...]``
    leaves where the reference stacks them (``scan_layers``, and always
    for the ssm and hybrid families), else a list of block dicts."""
    from repro_torch.models.model import layer_stacks, scanned, tree_get
    from repro_torch.train.optimizer import AdamWState
    dev = resolve_device(device)
    step, m, v = state
    for tree in (m, v):
        for path in layer_stacks(cfg):
            layers = tree_get(tree, path)
            if isinstance(layers, dict) != scanned(cfg):
                raise ValueError(f"the state's {'/'.join(path)} are "
                                 f"{type(layers).__name__}s; {cfg.name} (scan_layers="
                                 f"{cfg.scan_layers}) stacks them: {scanned(cfg)}")
    to = lambda a: _tensor(a, dev)  # noqa: E731
    return AdamWState(step=int(np.asarray(step)), m=tree_map(to, m), v=tree_map(to, v))


def kv_cache_from_numpy(cache, *, device=None) -> dict:
    """A stacked cache as ``init_cache``/``decode_step`` lay it out, on
    ``device`` in its own dtypes: the dense family's ``{k, v}`` ([L, B, S,
    Hkv, dh] each), the MoE family's ``{"dense": {ckv, krope} or None,
    "moe": {ckv, krope}}`` of MLA latents ([L, B, S, r] and [L, B, S,
    dr]), the ssm family's ``{state, x_time, x_chan}`` (the state
    float32), the hybrid family's ``{"ssm": {state, conv}, "shared":
    {k, v} or ()}``, or the audio family's ``{"self": {k, v}, "cross":
    (k, v)}`` ([L, B, n_frames, Hkv, dh] each)."""
    dev = resolve_device(device)

    def one(c):
        if isinstance(c, dict):
            return {name: one(part) for name, part in c.items()}
        if isinstance(c, tuple):
            return tuple(one(part) for part in c)
        return None if c is None else _tensor(c, dev)

    return one(cache)

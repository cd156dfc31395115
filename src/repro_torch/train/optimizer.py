"""AdamW with global-norm clipping and linear warmup: port of
``repro/train/optimizer.py``, with its two state-compression options:

* ``moment_dtype="bfloat16"``: moments stored in bf16 (updates in float32);
* ``factored=True``: an Adafactor-style factored second moment for leaves
  of two or more dimensions (row and column running means instead of the
  full tensor).

The state follows the reference's tree layout, not the module's: for a
:class:`~repro_torch.models.model.DecoderLM` with ``scan_layers`` its
per-layer parameters form :class:`~repro_torch.tree.Stacked` leaves and
their moments are stacked ``[L, ...]`` tensors, so the factored second
moment factors the leaves the reference factors (the ``[L, d]`` norm
scales across layers among them) and checkpoints cross between packages.

Where the reference chains leaves with ``optimization_barrier`` to keep one
leaf's float32 transients alive at a time, the port updates ``p``, ``m``
and ``v`` **in place**, leaf by leaf, largest first, a stacked leaf layer
by layer (its views), except the 1-D norm scales, whose ``[L, d]`` group
is updated together: its factored column mean couples the layers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.tree import Stacked, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    moment_dtype: str = "float32"
    factored: bool = False


class AdamWState(NamedTuple):
    step: int     # host int (the reference's int32 scalar; checkpoints store it so)
    m: Any
    v: Any        # full tensor, or {"row": ..., "col": ...} when factored


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _is_factored(v) -> bool:
    return isinstance(v, dict) and set(v) == {"row", "col"}


def _is_leaf(x) -> bool:
    return isinstance(x, Stacked) or _is_factored(x)


def _tree(params):
    """A DecoderLM's reference-layout tree, or ``params`` itself (a tree of
    tensors and Stacked leaves)."""
    return params.reference_tree() if hasattr(params, "reference_tree") else params


def init_adamw(params, cfg: AdamWConfig) -> AdamWState:
    mdt = getattr(torch, cfg.moment_dtype)

    def zeros(shape, dtype, like):
        device = (like[0] if isinstance(like, Stacked) else like).device
        return torch.zeros(shape, dtype=dtype, device=device)

    def vz(p):
        shape = tuple(p.shape)
        if cfg.factored and _factorable(shape):
            return {"row": zeros(shape[:-1], torch.float32, p),
                    "col": zeros(shape[:-2] + shape[-1:], torch.float32, p)}
        return zeros(shape, mdt, p)

    tree = _tree(params)
    return AdamWState(
        step=0,
        m=tree_map(lambda p: zeros(tuple(p.shape), mdt, p), tree, is_leaf=_is_leaf),
        v=tree_map(vz, tree, is_leaf=_is_leaf))


def _schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step`` (float32 arithmetic, as the reference's)."""
    warm = min(np.float32(step) / np.float32(max(cfg.warmup_steps, 1)), np.float32(1.0))
    return float(np.float32(cfg.learning_rate) * warm)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 on the device,
    leaf by leaf (a Stacked leaf layer by layer)."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _update(p, g, m, v, scale, lr: float, bc1: float, bc2: float, cfg: AdamWConfig) -> None:
    """The reference's ``upd_one`` on one piece, written into p, m and v."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.float() * scale
    m32 = b1 * m.float() + (1 - b1) * g
    g2 = g * g
    if _is_factored(v):
        row = b2 * v["row"] + (1 - b2) * torch.mean(g2, dim=-1)
        col = b2 * v["col"] + (1 - b2) * torch.mean(g2, dim=-2)
        # rank-1 reconstruction (Shazeer & Stern 2018)
        vhat = (row[..., None] * col[..., None, :]
                / torch.clamp(torch.mean(row, dim=-1)[..., None, None], min=1e-30)) / bc2
        v["row"].copy_(row)
        v["col"].copy_(col)
    else:
        v32 = b2 * v.float() + (1 - b2) * g2
        vhat = v32 / bc2
        v.copy_(v32)
    del g, g2
    mhat = m32 / bc1
    m.copy_(m32)
    del m32
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
    del mhat, vhat
    p.copy_(p.float() - lr * delta)


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """Returns (params, new_state, metrics): ``params`` (the same object)
    and the state's tensors are updated in place.  ``grads`` has the
    structure of the parameters' reference-layout tree (a Stacked leaf's
    gradients as a Stacked of per-layer tensors).  Metrics: ``grad_norm``
    (a device scalar) and ``lr`` (a float); nothing is read back from the
    device."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.tensor(cfg.grad_clip, dtype=torch.float32, device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = _schedule(cfg, step)
    stepf = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(cfg.beta1) ** stepf)
    bc2 = float(np.float32(1.0) - np.float32(cfg.beta2) ** stepf)

    p_leaves = tree_leaves(_tree(params), _is_leaf)
    g_leaves = tree_leaves(grads, _is_leaf)
    m_leaves = tree_leaves(state.m, _is_leaf)
    v_leaves = tree_leaves(state.v, _is_leaf)
    sizes = [int(np.prod(p.shape)) for p in p_leaves]
    with torch.no_grad():
        for i in sorted(range(len(p_leaves)), key=lambda i: -sizes[i]):
            p, g, m, v = p_leaves[i], g_leaves[i], m_leaves[i], v_leaves[i]
            if not isinstance(p, Stacked):
                _update(p, g, m, v, scale, lr, bc1, bc2, cfg)
            elif p[0].dim() >= 2:
                # the layer's views: a [in, out] weight factors alike per layer
                for layer, (pl, gl) in enumerate(zip(p, g)):
                    vl = ({"row": v["row"][layer], "col": v["col"][layer]}
                          if _is_factored(v) else v[layer])
                    _update(pl, gl, m[layer], vl, scale, lr, bc1, bc2, cfg)
            else:
                stacked = torch.stack(list(p))
                _update(stacked, torch.stack(list(g)), m, v, scale, lr, bc1, bc2, cfg)
                for pl, new in zip(p, stacked):
                    pl.copy_(new)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics

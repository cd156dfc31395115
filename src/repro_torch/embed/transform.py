"""Out-of-sample t-SNE ``transform``: descend new points into a frozen fit.
Port of ``repro/embed/transform.py``.

The fitted embedding is a frozen reference: each new point finds its k
nearest fitted input points (through the neighbor backend's query index),
gets perplexity-calibrated similarities over exactly those k rows, and
runs attractive-only gradient descent against their never-moving
embedding coordinates.  No refit, no repulsion, no interaction between
new points.

:func:`transform_batch` cuts the new points into batches of
``TransformConfig.batch_size`` rows (the last one zero-padded), so every
step has the same ``[B, K]`` shapes, as the reference's jitted step has.
On the card the query's distance tiles (an exact index) go through the
``pairwise_sq_dists`` kernel and the perplexity search through
``bsp_search``.  The :class:`~repro_torch.embed.service.EmbeddingService`
calls the same step over its ``[slots, max_k]`` pool.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import bsp
from repro_torch.core.attractive import attractive_forces_frozen

# One count per distinct (shape, static-arg) key of transform_step, the
# reference's key, recorded on every call (the port compiles nothing).
# Tests assert that ``RETRACE_PROBE.count`` does not grow across batch
# payloads: every step has the batch's fixed shape.  Service telemetry
# reports it as ``recompiles.transform_step``.
RETRACE_PROBE = obs.RecompileProbe("transform_step")


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    """Knobs of the attractive-only descent (defaults match FIt-SNE's
    late-phase optimizer scaled to per-row-normalized similarities)."""

    n_iter: int = 120                 # max descent iterations per point
    learning_rate: float = 0.5
    momentum_initial: float = 0.5
    momentum_final: float = 0.8
    momentum_switch_iter: int = 30
    min_gain: float = 0.01
    min_grad_norm: float = 1e-5       # per-point convergence threshold
    check_every: int = 10             # host-side convergence-check period
    batch_size: int = 128             # fixed batch width for transform()
    perplexity: float | None = None   # None = the fitted model's perplexity


class TransformState(NamedTuple):
    """Per-point descent state (all rows independent)."""
    y: torch.Tensor          # [B, 2] current coordinates
    velocity: torch.Tensor   # [B, 2]
    gains: torch.Tensor      # [B, 2]


class TransformStats(NamedTuple):
    """Per-point outcome of a transform batch (host-side numpy)."""
    n_steps: np.ndarray       # iterations until convergence (or n_iter cap)
    grad_norm: np.ndarray     # final per-point gradient norm
    kl_attr: np.ndarray       # final per-point sum p log(1 + d^2)


def transform_step(state: TransformState, p: torch.Tensor, nbr_y: torch.Tensor,
                   active: torch.Tensor, momentum, *, lr: float, min_gain: float):
    """One attractive-only descent step; returns (state, grad_norm [B],
    kl_attr [B]).  The same momentum/gains rule as the full optimizer.

    p [B, K] row-normalized similarities (pad rows: 0); nbr_y [B, K, 2]
    frozen fitted coordinates; active [B] bool (frozen rows keep their
    coordinates); momentum a scalar or [B].
    """
    RETRACE_PROBE.record(tuple(state.y.shape), tuple(p.shape), lr, min_gain)
    force, kl_attr = attractive_forces_frozen(state.y, nbr_y, p)
    grad = 4.0 * force
    grad_norm = torch.linalg.norm(grad, dim=1)
    same_sign = (grad > 0) == (state.velocity > 0)
    gains = torch.where(same_sign, state.gains * 0.8, state.gains + 0.2)
    gains = torch.clamp_min(gains, min_gain)
    mom = torch.as_tensor(momentum, dtype=state.y.dtype, device=state.y.device)
    velocity = mom[..., None] * state.velocity - lr * gains * grad
    y = torch.where(active[:, None], state.y + velocity, state.y)
    return TransformState(y=y, velocity=velocity, gains=gains), grad_norm, kl_attr


def prepare_batch(x_new: torch.Tensor, index, y_ref: torch.Tensor, k: int,
                  perplexity: float):
    """Admission path: query + perplexity search + neighbor-weighted init.

    Returns ``(p [M, k], nbr_y [M, k, 2], y0 [M, 2])``.  ``y0`` is the
    p-weighted mean of the fitted neighbors' coordinates: already inside the
    right cluster, so the descent only fine-tunes.
    """
    idx, d2 = index.query(x_new, k)
    # perplexity can't exceed the support size: k rows bound entropy at log k
    eff_perp = min(float(perplexity), max(1.0, 0.5 * k))
    p, _ = bsp.binary_search_perplexity(d2, eff_perp)
    nbr_y = y_ref[idx.long()]
    y0 = torch.einsum("mk,mkc->mc", p, nbr_y)
    return p, nbr_y, y0


def transform_batch(x_new: torch.Tensor, index, y_ref: torch.Tensor, *, k: int,
                    perplexity: float, config: TransformConfig = TransformConfig(),
                    tracer: obs.Tracer | None = None):
    """Embed ``x_new [M, D]`` into the frozen fit ``y_ref [N, 2]``; M is
    arbitrary.  Both tensors lie on the index's device.

    Chunks of ``config.batch_size`` rows (zero-padded) run through
    :func:`transform_step`; each chunk stops early once every live point's
    gradient norm drops under ``min_grad_norm`` (read on the host every
    ``check_every`` iterations, as the full loop's convergence rule).
    Returns ``(y [M, 2] numpy, TransformStats)``.

    When ``tracer`` (default: the process-global tracer) is enabled the call
    is one ``transform`` span with a ``transform.prepare`` (query +
    perplexity search, synchronised on ``p`` and ``y0``) and a
    ``transform.descend`` child per chunk.
    """
    if tracer is None:
        tracer = obs.get_tracer()
    m = int(x_new.shape[0])
    bs = config.batch_size
    dev = x_new.device
    out_y = np.zeros((m, 2), np.float32)
    out_steps = np.zeros(m, np.int32)
    out_gn = np.zeros(m, np.float32)
    out_kl = np.zeros(m, np.float32)
    with tracer.span("transform", m=m, k=k, batch_size=bs):
        for lo in range(0, m, bs):
            chunk = x_new[lo:lo + bs]
            c = int(chunk.shape[0])
            pad = bs - c
            with tracer.span("transform.prepare", rows=c) as sp_prep:
                p, nbr_y, y0 = prepare_batch(chunk, index, y_ref, k, perplexity)
                sp_prep.sync((p, y0))
            with tracer.span("transform.descend", rows=c):
                if pad:
                    p = torch.nn.functional.pad(p, (0, 0, 0, pad))
                    nbr_y = torch.nn.functional.pad(nbr_y, (0, 0, 0, 0, 0, pad))
                    y0 = torch.nn.functional.pad(y0, (0, 0, 0, pad))
                state = TransformState(y=y0, velocity=torch.zeros_like(y0),
                                       gains=torch.ones_like(y0))
                valid = np.arange(bs) < c
                active_h = valid.copy()
                active = torch.as_tensor(active_h, device=dev)
                steps = np.zeros(bs, np.int32)
                gn_h = np.zeros(bs, np.float32)
                kl_h = np.zeros(bs, np.float32)
                it = 0
                for it in range(config.n_iter):
                    mom = config.momentum_initial if it < config.momentum_switch_iter \
                        else config.momentum_final
                    state, gn, kl_attr = transform_step(state, p, nbr_y, active, mom,
                                                        lr=config.learning_rate,
                                                        min_gain=config.min_gain)
                    if (it + 1) % config.check_every == 0 or it == config.n_iter - 1:
                        gn_np = gn.cpu().numpy()
                        kl_np = kl_attr.cpu().numpy()
                        newly = active_h & (gn_np < config.min_grad_norm)
                        steps[newly] = it + 1
                        gn_h[active_h] = gn_np[active_h]
                        kl_h[active_h] = kl_np[active_h]
                        active_h = active_h & ~newly
                        if not active_h.any():
                            break
                        active = torch.as_tensor(active_h, device=dev)
                steps[active_h] = it + 1
                out_y[lo:lo + c] = state.y[:c].cpu().numpy()
                out_steps[lo:lo + c] = steps[:c]
                out_gn[lo:lo + c] = gn_h[:c]
                out_kl[lo:lo + c] = kl_h[:c]
    return out_y, TransformStats(n_steps=out_steps, grad_norm=out_gn, kl_attr=out_kl)

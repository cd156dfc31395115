"""Gradient compression with error feedback: port of
``repro/distributed/compression.py``'s tree transform.

int8 uniform quantization per leaf (scale = max|g| / 127), with the
quantization residual carried to the next step (error feedback, Seide et
al. 2014 / Karimireddy et al. 2019) so the bias vanishes in expectation.
Bit for bit the reference's: ``torch.round`` rounds half to even, as
``jnp.round`` does.  ``compressed_psum``, the collective building block,
comes with multi-device training (ROADMAP.md §1 item 2, slice 2b).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


class EFState(NamedTuple):
    residual: Any


def init_error_feedback(params) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def _quantize(x: torch.Tensor):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads, ef: EFState):
    """Returns (compressed-and-decompressed grads, new EF state)."""

    def one(g, r):
        g32 = g.float() + r
        q, scale = _quantize(g32)
        deq = _dequantize(q, scale)
        return deq.to(g.dtype), g32 - deq

    out = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(ef.residual))]
    return (tree_unflatten_like(grads, [o[0] for o in out]),
            EFState(residual=tree_unflatten_like(ef.residual, [o[1] for o in out])))

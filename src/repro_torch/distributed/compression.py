"""Gradient compression with error feedback: port of
``repro/distributed/compression.py``.

int8 uniform quantization per leaf (scale = max|g| / 127), with the
quantization residual carried to the next step (error feedback, Seide et
al. 2014 / Karimireddy et al. 2019) so the bias vanishes in expectation.
Bit for bit the reference's: ``torch.round`` rounds half to even, as
``jnp.round`` does.  Two entry points:

* ``compress_grads``: a pure tree transform;
* ``compressed_psum``: the collective building block over one mesh axis's
  per-shard tensors: quantize, sum the int32 payloads, dequantize (8x
  fewer bytes on the wire than a float32 all-reduce).  Like the
  reference's, nothing in the trainer calls it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distributed.collectives import Mesh, pmax, psum
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


def compressed_psum(mesh: Mesh, values) -> list[torch.Tensor]:
    """int8-quantized psum over a 1-D mesh (a named axis's group): each
    shard's scale is ``max|x| / 127``, the scales are pmax'd so every shard
    dequantizes alike, the int32 payloads are summed in rank order, and
    rank r gets the float32 sum on its device."""
    scales = [torch.clamp(torch.max(torch.abs(x)), min=1e-30) / 127.0 for x in values]
    scales = pmax(mesh, scales)
    q = [torch.clamp(torch.round(x / s), -127, 127).to(torch.int32)
         for x, s in zip(values, scales)]
    return [total.float() * s for total, s in zip(psum(mesh, q), scales)]

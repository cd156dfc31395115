"""Morton (Z-order) codes, paper Algorithm 1: port of ``repro/core/morton.py``.

The codes are 32-bit Morton codes (16 bits a dimension, quadtree depth
<= 16), carried as ``int64``: PyTorch on the CPU implements neither the
shifts nor ``cummin`` / ``searchsorted`` for ``uint32``, and the quadtree
build needs all three.  Every code fits in the low 32 bits, so the values
equal the reference's ``uint32`` codes.

:func:`morton_encode` is the plain twin of the CUDA kernel
``csrc/morton.cu`` (registry name ``morton_encode``).
"""
from __future__ import annotations

import math

import torch

DEFAULT_DEPTH = 16  # quadtree levels below the root; 2 bits/level -> 32-bit code

# Magic masks for the 16 -> 32 bit interleave (Alg. 1 lines 9-18, 32-bit form)
_MASKS = ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555))


def auto_depth(n: int) -> int:
    """Depth that keeps ~<1 expected point per finest cell with margin."""
    return int(min(16, max(8, math.ceil(math.log2(max(n, 2)) / 2) + 4)))


def expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of int64 ``v`` so bit i moves to bit 2i."""
    v = v & 0x0000FFFF
    for shift, mask in _MASKS:
        v = (v | (v << shift)) & mask
    return v


def span_radius(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bounding-square center and half-span (r_span) of embedding ``y [N,2]``."""
    lo = torch.amin(y, dim=0)
    hi = torch.amax(y, dim=0)
    cent = 0.5 * (lo + hi)
    # strictly positive span so the scale below is finite for degenerate inputs
    r = torch.clamp_min(torch.amax(0.5 * (hi - lo)), 1e-30)
    # tiny inflation so points on the max boundary land inside the last cell
    r = r * (1.0 + 1e-6) + 1e-30
    return cent, r


def root_params(cent: torch.Tensor, r_span: torch.Tensor, depth: int) -> torch.Tensor:
    """(root_x, root_y, scale) of the root cell, [3] on ``cent``'s device."""
    y_root = cent - r_span                                  # Alg.1 line 4
    scale = (2.0 ** (depth - 1)) / r_span                   # Alg.1 line 5
    return torch.stack([y_root[0], y_root[1], scale.to(cent.dtype)])


def check_depth(depth: int) -> None:
    if not 1 <= depth <= 16:
        raise ValueError(f"depth must be in [1, 16] for 32-bit codes, got {depth}")


def morton_encode(y: torch.Tensor, cent: torch.Tensor, r_span: torch.Tensor,
                  depth: int = DEFAULT_DEPTH) -> torch.Tensor:
    """Paper Algorithm 1: embedding points [N, 2] -> Morton codes [N] int64."""
    check_depth(depth)
    params = root_params(cent, r_span, depth)
    m = (y - params[None, :2]) * params[2]
    m = torch.clamp(m, 0.0, float(2**depth) - 1.0).to(torch.int64)
    code = expand_bits(m[:, 0]) | (expand_bits(m[:, 1]) << 1)   # Alg.1 line 21
    if depth < 16:
        # keep codes left-aligned at bit 2*depth so prefix logic is uniform
        code = code & ((1 << (2 * depth)) - 1)
    return code


def morton_decode_cell(code: torch.Tensor, level: int, depth: int = DEFAULT_DEPTH):
    """Integer (x, y) cell coordinates of ``code``'s prefix at ``level``."""
    pfx = code >> (2 * (depth - level))
    return _compact_bits(pfx), _compact_bits(pfx >> 1)


def _compact_bits(v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`expand_bits`: bit 2i of int64 ``v`` moves to bit i."""
    v = v & 0x55555555
    for shift, mask in ((1, 0x33333333), (2, 0x0F0F0F0F), (4, 0x00FF00FF), (8, 0x0000FFFF)):
        v = (v | (v >> shift)) & mask
    return v

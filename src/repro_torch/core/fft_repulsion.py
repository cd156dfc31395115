"""FIt-SNE-style FFT-accelerated repulsion (Linderman et al., 2019): port of
``repro/core/fft_repulsion.py``.

Polynomial interpolation onto a regular node lattice, kernel convolution by
FFT (circulant embedding), and interpolation back:

    phi_k(x_i) ~= sum_(p^2 nodes) L_p(x_i) * (K * spread(charges))[node]

Charges {1, y_x, y_y} against K2 = (1+d^2)^-2 give the repulsive numerator;
charge {1} against K1 = (1+d^2)^-1 gives Z.

:func:`spread_to_grid` and :func:`gather_from_grid` are the plain twins of
the CUDA kernels ``csrc/spread.cu`` / ``csrc/gather.cu`` (registry names
``fft_spread`` / ``fft_gather``); :func:`fft_repulsion` calls them through
``repro_torch.kernels.ops``, so the tensor's device picks kernel or plain
version.  :func:`interp_coords` and the FFTs (``torch.fft``, cuFFT on the
card) stay outside the kernels, as the JAX package keeps them in XLA.
"""
from __future__ import annotations

import torch

P_ORDER = 3  # interpolation nodes per box per dim

# Hard cap on the boxes-per-dim lattice resolution (the reference's
# envelope).  The spread kernel keeps a band of lattice rows in shared
# memory, which fits at every size up to this one.
MAX_N_BOXES = 128

def check_n_boxes(n_boxes: int) -> None:
    if not 1 <= n_boxes <= MAX_N_BOXES:
        raise ValueError(
            f"n_boxes={n_boxes} outside [1, {MAX_N_BOXES}] (MAX_N_BOXES, the "
            "reference's envelope for the interpolation kernels)"
        )


def lattice_nodes(n_boxes: int) -> int:
    """Nodes per dimension of an n_boxes lattice (boxes share edge nodes)."""
    return n_boxes * (P_ORDER - 1) + 1


def _lagrange_weights(frac: torch.Tensor) -> torch.Tensor:
    """Weights of the 3 equispaced nodes {0, .5, 1} for position frac [N]."""
    t = frac
    w0 = 2.0 * (t - 0.5) * (t - 1.0)
    w1 = -4.0 * t * (t - 1.0)
    w2 = 2.0 * t * (t - 0.5)
    return torch.stack([w0, w1, w2], dim=-1)  # [N, 3]


def interp_coords(y: torch.Tensor, n_boxes: int):
    """Lattice geometry shared by spread and gather.

    Returns (base [N,2] int32 -- the box-start node per dim, wx [N,3],
    wy [N,3] -- per-dim Lagrange weights, h -- node spacing, a 0-d tensor).
    """
    lo = torch.amin(y, dim=0) - 1e-4
    hi = torch.amax(y, dim=0) + 1e-4
    span = torch.clamp_min(torch.max(hi - lo), 1e-12)
    m = n_boxes * (P_ORDER - 1)            # interior lattice nodes per dim
    h = span / m
    u = (y - lo[None, :]) / h              # fractional lattice coords in [0, m)
    iu = torch.clamp(torch.floor(u / (P_ORDER - 1)).to(torch.int32), 0, n_boxes - 1)
    base = iu * (P_ORDER - 1)              # box start node
    frac = (u - base) / (P_ORDER - 1)      # [N,2] in [0,1]
    wx = _lagrange_weights(frac[:, 0])
    wy = _lagrange_weights(frac[:, 1])
    return base, wx, wy, h


def _taps(base: torch.Tensor, nodes: int):
    """Flat lattice index of each point's 3x3 taps and whether the tap lies
    on the lattice, both [N, 9].  Taps off the lattice get index 0 and are
    skipped, as the CUDA kernels skip them (``interp_coords`` never makes
    one)."""
    taps = torch.arange(P_ORDER, device=base.device)
    gx = base[:, 0, None].long() + taps    # [N,3]
    gy = base[:, 1, None].long() + taps
    on_x = (gx >= 0) & (gx < nodes)
    on_y = (gy >= 0) & (gy < nodes)
    n = base.shape[0]
    on = (on_x[:, :, None] & on_y[:, None, :]).reshape(n, P_ORDER * P_ORDER)
    flat = (gx[:, :, None] * nodes + gy[:, None, :]).reshape(n, P_ORDER * P_ORDER)
    return torch.where(on, flat, 0), on


def spread_to_grid(base, wx, wy, charges, nodes: int) -> torch.Tensor:
    """Scatter per-point charges onto the node lattice (plain version).

    base [N,2] int32, wx/wy [N,3], charges [N,C] -> grid [nodes, nodes, C]:
    grid[a, b, c] = sum_i wx[i, a - base_x[i]] * wy[i, b - base_y[i]] * charges[i, c]
    """
    n, c = charges.shape
    idx, on = _taps(base, nodes)
    w2d = (wx[:, :, None] * wy[:, None, :]).reshape(n, P_ORDER * P_ORDER)  # [N,9]
    contrib = w2d[:, :, None] * charges[:, None, :]             # [N,9,C]
    contrib = torch.where(on[:, :, None], contrib, 0.0)
    grid = torch.zeros((nodes * nodes, c), dtype=charges.dtype, device=charges.device)
    grid.index_add_(0, idx.reshape(-1), contrib.reshape(-1, c))
    return grid.reshape(nodes, nodes, c)


def gather_from_grid(pot, base, wx, wy) -> torch.Tensor:
    """Interpolate node potentials back at the points (plain version).

    pot [nodes, nodes, C], base [N,2] int32, wx/wy [N,3] -> phi [N, C]:
    the transpose of :func:`spread_to_grid` with unit charges.
    """
    nodes, _, c = pot.shape
    n = base.shape[0]
    idx, on = _taps(base, nodes)
    w2d = (wx[:, :, None] * wy[:, None, :]).reshape(n, P_ORDER * P_ORDER)  # [N,9]
    vals = torch.where(on[:, :, None], pot.reshape(-1, c)[idx], 0.0)  # [N,9,C]
    return torch.sum(vals * w2d[:, :, None], dim=1)             # [N,C]


def convolve(grid: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Kernel convolution of the spread charges, by FFT over the circulant
    embedding (size 2*nodes): grid [nodes, nodes, 3] -> pot [nodes, nodes, 4]
    with channels {sum K2, sum K2*yx, sum K2*yy, sum K1 (incl self)}.

    The five transforms run channel-first, [C, big, big], over the last
    two dims (cuFFT on the card, pocketfft on the CPU).
    """
    nodes = grid.shape[0]
    big = 2 * nodes
    ar = torch.arange(big, device=grid.device)
    dx = torch.minimum(ar, big - ar).to(grid.dtype) * h
    d2 = dx[:, None] ** 2 + dx[None, :] ** 2
    k1 = 1.0 / (1.0 + d2)
    k2 = k1 * k1
    fk1 = torch.fft.rfft2(k1)
    fk2 = torch.fft.rfft2(k2)
    gpad = torch.zeros((grid.shape[2], big, big), dtype=grid.dtype, device=grid.device)
    gpad[:, :nodes, :nodes] = grid.permute(2, 0, 1)
    fg = torch.fft.rfft2(gpad)
    pot2 = torch.fft.irfft2(fg * fk2, s=(big, big))[:, :nodes, :nodes]
    pot1 = torch.fft.irfft2(fg[0] * fk1, s=(big, big))[:nodes, :nodes]
    return torch.stack([pot2[0], pot2[1], pot2[2], pot1], dim=2)


def point_charges(y: torch.Tensor) -> torch.Tensor:
    """The charges {1, yx, yy} of each point, [N, 3]."""
    return torch.stack([torch.ones_like(y[:, 0]), y[:, 0], y[:, 1]], dim=1)


def forces_from_potentials(y: torch.Tensor, phi: torch.Tensor):
    """(force_unnorm [N,2], z) from the gathered potentials phi [N, 4]."""
    z = torch.sum(phi[:, 3]) - y.shape[0]                  # remove self terms
    fx = y[:, 0] * phi[:, 0] - phi[:, 1]                   # self term cancels
    fy = y[:, 1] * phi[:, 0] - phi[:, 2]
    return torch.stack([fx, fy], dim=1), torch.clamp_min(z, 1e-30)


def fft_repulsion(y: torch.Tensor, n_boxes: int = 48):
    """Returns (force_unnorm [N,2], z) matching exact_repulsion's contract.

    Spread and gather go through ``ops.fft_spread`` / ``ops.fft_gather``,
    which launch the CUDA kernels for a CUDA ``y`` and run the plain
    versions above for a CPU ``y``.
    """
    from repro_torch.kernels import ops     # lazy: ops imports this module
    check_n_boxes(n_boxes)
    base, wx, wy, h = interp_coords(y, n_boxes)
    # spread charges {1, yx, yy} onto the nodes^2 lattice, convolve, and
    # gather all four potentials back at the points in one pass
    grid = ops.fft_spread(base, wx, wy, point_charges(y), lattice_nodes(n_boxes))
    phi = ops.fft_gather(convolve(grid, h), base, wx, wy)      # [N, 4]
    return forces_from_potentials(y, phi)

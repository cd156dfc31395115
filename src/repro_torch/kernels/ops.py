"""Wrappers of the hand-written CUDA kernels + the kernel registry.

Port of ``repro/kernels/ops.py``.  Each wrapper checks its inputs (dtype,
shape, contiguity, one device) and then lets the tensors' device choose:

* a CUDA tensor launches the kernel from ``csrc/<name>.cu`` on the current
  stream (built and loaded by :mod:`repro_torch.kernels.build` at first
  use) and raises if the launch fails: there is no fall-back;
* a CPU tensor runs the kernel's plain PyTorch twin in ``repro_torch.core``.

Each wrapper adds one to its entry in :data:`LAUNCHES` where it launches
its kernel, and nowhere else, so a run can show that it went through the
kernels.  :func:`kernel_registry` lists every ported kernel with its plain
version, CUDA wrapper, CUDA source and the TPU kernel it replaces.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import _pairwise, attractive, bsp, fft_repulsion, morton
from repro_torch.kernels import build

LAUNCHES: dict[str, int] = {
    "pairwise_sq_dists": 0, "bsp_search": 0, "morton_encode": 0,
    "attractive_ell": 0, "fft_spread": 0, "fft_gather": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "pairwise": ("pairwise_sq_dists", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "bsp": ("bsp_search", [_P, _P, _P, _I, _I, _F, _F, _I, _P]),
    "morton": ("morton_encode", [_P, _P, _P, _I, _I, _P]),
    "attractive": ("attractive_ell", [_P, _P, _P, _P, _P, _P, _I, _I, _P]),
    "spread": ("fft_spread", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _P]),
    "gather": ("fft_gather", [_P, _P, _P, _P, _P, _I, _I, _P]),
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry(source: str):
    """The C entry point of ``csrc/<source>.cu`` with its argtypes set."""
    symbol, argtypes = _SIGNATURES[source]
    fn = getattr(build.load(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, source: str, device: torch.device, *args) -> None:
    """Launch on ``device``'s current stream, with ``device`` current (the C
    entry launches in the runtime's current device context)."""
    with torch.cuda.device(device):
        err = _entry(source)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    LAUNCHES[name] += 1


def _check(arg: str, t, dtype: torch.dtype, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{arg}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{arg}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{arg}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{arg}: must be contiguous")


def _device(**tensors) -> torch.device:
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# pairwise_sq_dists
# ---------------------------------------------------------------------------

def pairwise_sq_dists(q: torch.Tensor, db: torch.Tensor,
                      q_sqn: torch.Tensor | None = None,
                      db_sqn: torch.Tensor | None = None) -> torch.Tensor:
    """max(|q|^2 + |db|^2 - 2 q db^T, 0): [Q, D] x [C, D] -> [Q, C] fp32."""
    if q_sqn is None:
        q_sqn = torch.sum(q * q, dim=1)
    if db_sqn is None:
        db_sqn = torch.sum(db * db, dim=1)
    for arg, t, nd in (("q", q, 2), ("db", db, 2), ("q_sqn", q_sqn, 1),
                       ("db_sqn", db_sqn, 1)):
        _check(arg, t, torch.float32, nd)
    nq, d = q.shape
    nc = db.shape[0]
    if db.shape[1] != d or q_sqn.shape[0] != nq or db_sqn.shape[0] != nc:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, db {tuple(db.shape)}, "
                         f"q_sqn {tuple(q_sqn.shape)}, db_sqn {tuple(db_sqn.shape)}")
    if _device(q=q, db=db, q_sqn=q_sqn, db_sqn=db_sqn).type == "cpu":
        return _pairwise.pairwise_sq_dists(q, db, q_sqn, db_sqn)
    return pairwise_sq_dists_cuda(q, db, q_sqn, db_sqn)


def pairwise_sq_dists_cuda(q, db, q_sqn, db_sqn) -> torch.Tensor:
    nq, d = q.shape
    nc = db.shape[0]
    out = torch.empty((nq, nc), dtype=torch.float32, device=q.device)
    if nq and nc:
        _launch("pairwise_sq_dists", "pairwise", q.device, q.data_ptr(), db.data_ptr(),
                q_sqn.data_ptr(), db_sqn.data_ptr(), out.data_ptr(), nq, nc, d)
    return out


# ---------------------------------------------------------------------------
# bsp_search
# ---------------------------------------------------------------------------

MAX_K = 1024   # one warp holds a row in registers: 32 lanes x 32 values


def bsp_search(d2: torch.Tensor, perplexity: float, iters: int = 64,
               tol: float = 1e-5):
    """Fused perplexity search: d2 [N, K] fp32 -> (cond_p [N, K], beta [N])."""
    _check("d2", d2, torch.float32, 2)
    if not 1 <= d2.shape[1] <= MAX_K:
        raise ValueError(f"K={d2.shape[1]} must be in [1, {MAX_K}]")
    if _device(d2=d2).type == "cpu":
        return bsp.binary_search_perplexity_plain(d2, perplexity, iters, tol)
    return bsp_search_cuda(d2, perplexity, iters, tol)


def bsp_search_cuda(d2, perplexity: float, iters: int = 64, tol: float = 1e-5):
    n, k = d2.shape
    cond_p = torch.empty_like(d2)
    beta = torch.empty((n,), dtype=torch.float32, device=d2.device)
    if n:
        _launch("bsp_search", "bsp", d2.device, d2.data_ptr(), cond_p.data_ptr(),
                beta.data_ptr(), n, k, bsp.log_perplexity(perplexity), tol,
                int(iters))
    return cond_p, beta


# ---------------------------------------------------------------------------
# morton_encode
# ---------------------------------------------------------------------------

def morton_encode(y: torch.Tensor, cent: torch.Tensor, r_span: torch.Tensor,
                  depth: int = morton.DEFAULT_DEPTH) -> torch.Tensor:
    """Algorithm 1: y [N, 2] fp32 -> Morton codes [N] int64."""
    _check("y", y, torch.float32, 2)
    _check("cent", cent, torch.float32, 1)
    _check("r_span", r_span, torch.float32, 0)
    if y.shape[1] != 2 or cent.shape[0] != 2:
        raise ValueError(f"expected y [N, 2] and cent [2], got {tuple(y.shape)}, "
                         f"{tuple(cent.shape)}")
    morton.check_depth(depth)
    if _device(y=y, cent=cent, r_span=r_span).type == "cpu":
        return morton.morton_encode(y, cent, r_span, depth)
    return morton_encode_cuda(y, cent, r_span, depth)


def morton_encode_cuda(y, cent, r_span, depth: int = morton.DEFAULT_DEPTH):
    n = y.shape[0]
    params = morton.root_params(cent, r_span, depth).contiguous()
    codes = torch.empty((n,), dtype=torch.int64, device=y.device)
    if n:
        _launch("morton_encode", "morton", y.device, y.data_ptr(), params.data_ptr(),
                codes.data_ptr(), n, depth)
    return codes


# ---------------------------------------------------------------------------
# attractive_ell
# ---------------------------------------------------------------------------

def attractive_ell(y: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                   row_len: torch.Tensor | None = None):
    """Algorithm 2: y [N, 2], cols [N, W] int32, vals [N, W] -> (F [N, 2], KL).

    ``row_len`` [N] int32 in [0, W] is the number of real entries of each
    row (``NeighborGraph.p_len``); entries at or past it are ignored by
    kernel and plain version alike.  ``None``: every row is W long.  Its
    range is checked on the CPU only: on the card the check would read the
    lengths back, a host sync every descent step.  There the kernel clamps
    each length into [0, W], as the plain version's mask does.
    """
    _check("y", y, torch.float32, 2)
    _check("cols", cols, torch.int32, 2)
    _check("vals", vals, torch.float32, 2)
    n, w = cols.shape
    if y.shape != (n, 2) or vals.shape != (n, w):
        raise ValueError(f"expected y [N, 2], cols and vals [N, W]; got y "
                         f"{tuple(y.shape)}, cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}")
    tensors = dict(y=y, cols=cols, vals=vals)
    if row_len is not None:
        _check("row_len", row_len, torch.int32, 1)
        if row_len.shape[0] != n:
            raise ValueError(f"row_len: expected shape ({n},), got {tuple(row_len.shape)}")
        tensors["row_len"] = row_len
    dev = _device(**tensors)
    if dev.type == "cpu" and row_len is not None and n:
        lo, hi = (int(v) for v in torch.aminmax(row_len))
        if lo < 0 or hi > w:
            raise ValueError(f"row_len: values must lie in [0, {w}], got [{lo}, {hi}]")
    if dev.type == "cpu":
        return attractive.attractive_forces_ell(y, cols, vals, row_len)
    return attractive_ell_cuda(y, cols, vals, row_len)


def attractive_ell_cuda(y, cols, vals, row_len=None):
    n, w = cols.shape
    if y.data_ptr() % 8:
        raise ValueError("y must be 8-byte aligned (the kernel reads a point as a float2)")
    force = torch.empty((n, 2), dtype=torch.float32, device=y.device)
    kl_rows = torch.empty((n,), dtype=torch.float32, device=y.device)
    if n:
        _launch("attractive_ell", "attractive", y.device, y.data_ptr(), cols.data_ptr(),
                vals.data_ptr(), None if row_len is None else row_len.data_ptr(),
                force.data_ptr(), kl_rows.data_ptr(), n, w)
    # per-row partials summed here, as attractive_kernel.py sums them:
    # deterministic, no atomics
    return force, torch.sum(kl_rows)


# ---------------------------------------------------------------------------
# fft_spread / fft_gather
# ---------------------------------------------------------------------------

def _check_interp(base, wx, wy, n_rows: int) -> None:
    _check("base", base, torch.int32, 2)
    _check("wx", wx, torch.float32, 2)
    _check("wy", wy, torch.float32, 2)
    p = fft_repulsion.P_ORDER
    if base.shape != (n_rows, 2) or wx.shape != (n_rows, p) or wy.shape != (n_rows, p):
        raise ValueError(f"expected base [N, 2], wx and wy [N, {p}]; got base "
                         f"{tuple(base.shape)}, wx {tuple(wx.shape)}, wy {tuple(wy.shape)}")


def _check_nodes(nodes: int) -> None:
    """nodes = n_boxes * (P_ORDER - 1) + 1 with n_boxes in [1, MAX_N_BOXES]."""
    n_boxes, rem = divmod(nodes - 1, fft_repulsion.P_ORDER - 1)
    if rem or not 1 <= n_boxes <= fft_repulsion.MAX_N_BOXES:
        raise ValueError(f"nodes={nodes} is not 2 * n_boxes + 1 with n_boxes in "
                         f"[1, {fft_repulsion.MAX_N_BOXES}]")


# Launch plan of csrc/spread.cu.  Its shared-memory layout is mirrored in
# spread_smem_bytes, and the C entry refuses a plan whose byte count
# differs from its own.  The numbers are the ones chip_variants.py's spread
# set picked on an H100 (PERF.md, Findings).
SPREAD_SCAN = 8              # batches of 32 points a warp scans a segment (SCAN)
SPREAD_ROWS = 4              # lattice rows a band
SPREAD_WARPS = 8             # warps a CTA, at most
SPREAD_POINTS_A_WARP = 64    # fewest points a slice gives each warp
SPREAD_MAX_SLICES = 8        # CTAs a band: one cluster, at most the portable size
SMEM_LIMIT = 232_448         # dynamic shared memory a block can opt into (227 KiB)
SMEM_TWO_A_SM = 115_712      # at most this much lets two blocks share an SM (228 KiB)


class SpreadPlan(NamedTuple):
    rows_per_band: int
    slices: int
    warps: int
    smem_bytes: int


def spread_smem_bytes(nodes: int, channels: int, rows: int, warps: int) -> int:
    """Dynamic shared memory of one spread CTA: per warp one band copy (rows
    padded to 3 c banks apart), a dummy word, 32 tap records (offset, mask,
    9 c products; an odd word count), its SCAN x 32 places of the segment's
    hit list and its hit count."""
    p = fft_repulsion.P_ORDER
    words = nodes * channels
    stride = words + (3 * channels - words) % 32
    record = (p * p * channels + 2) | 1
    return 4 * warps * (rows * stride + 1 + 32 * record + SPREAD_SCAN * 32 + 1)


def spread_plan(n: int, nodes: int, channels: int = 3) -> SpreadPlan:
    """The spread kernel's launch plan for n points on a nodes x nodes x
    channels lattice: bands of ``rows_per_band`` rows (grid.y =
    ceil(nodes / rows)), ``slices`` CTAs a band, one cluster (grid.x), each
    walking a contiguous slice of the points with ``warps`` warps.  From
    SPREAD_ROWS and SPREAD_WARPS, warps are halved until two CTAs fit an
    SM's shared memory (at 128 boxes: 4), rows until one does; a slice gets
    at least SPREAD_POINTS_A_WARP points a warp.  Depends on the shapes
    only, so every call at the same shapes sums in the same order."""
    rows, warps = min(SPREAD_ROWS, nodes), SPREAD_WARPS
    while warps > 1 and spread_smem_bytes(nodes, channels, rows, warps) > SMEM_TWO_A_SM:
        warps //= 2
    while True:
        smem = spread_smem_bytes(nodes, channels, rows, warps)
        if smem <= SMEM_LIMIT:
            slices = max(1, min(SPREAD_MAX_SLICES, -(-n // (SPREAD_POINTS_A_WARP * warps))))
            return SpreadPlan(rows, slices, warps, smem)
        if rows > 1:
            rows //= 2
        else:
            raise ValueError(f"fft_spread: {channels} channels on a {nodes}-node lattice "
                             f"need {smem} bytes of shared memory a band row, over "
                             f"{SMEM_LIMIT}")


def fft_spread(base: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
               charges: torch.Tensor, nodes: int) -> torch.Tensor:
    """Spread charges [N, C] onto the lattice: -> grid [nodes, nodes, C] fp32.

    Taps off the lattice are skipped by kernel and plain version alike
    (``interp_coords`` makes none).
    """
    _check("charges", charges, torch.float32, 2)
    _check_interp(base, wx, wy, charges.shape[0])
    _check_nodes(nodes)
    if _device(base=base, wx=wx, wy=wy, charges=charges).type == "cpu":
        return fft_repulsion.spread_to_grid(base, wx, wy, charges, nodes)
    return fft_spread_cuda(base, wx, wy, charges, nodes)


def fft_spread_cuda(base, wx, wy, charges, nodes: int) -> torch.Tensor:
    n, c = charges.shape
    if base.data_ptr() % 8:
        raise ValueError("base must be 8-byte aligned (the kernel reads a point's base as an int2)")
    # every node is written by the kernel: no zeroing
    grid = torch.empty((nodes, nodes, c), dtype=torch.float32, device=charges.device)
    if c:
        _launch("fft_spread", "spread", charges.device, base.data_ptr(), wx.data_ptr(),
                wy.data_ptr(), charges.data_ptr(), grid.data_ptr(), n, nodes, c,
                *spread_plan(n, nodes, c))
    return grid


def fft_gather(pot: torch.Tensor, base: torch.Tensor, wx: torch.Tensor,
               wy: torch.Tensor) -> torch.Tensor:
    """Interpolate pot [nodes, nodes, 4] at the points: -> phi [N, 4] fp32.

    The four channels are fft_repulsion's potentials (the CUDA kernel reads
    a tap as one float4).  Taps off the lattice are skipped by kernel and
    plain version alike (``interp_coords`` makes none).
    """
    _check("pot", pot, torch.float32, 3)
    _check_interp(base, wx, wy, base.shape[0])
    if pot.shape[0] != pot.shape[1] or pot.shape[2] != 4:
        raise ValueError(f"pot must be [nodes, nodes, 4], got {tuple(pot.shape)}")
    _check_nodes(pot.shape[0])
    if _device(pot=pot, base=base, wx=wx, wy=wy).type == "cpu":
        return fft_repulsion.gather_from_grid(pot, base, wx, wy)
    return fft_gather_cuda(pot, base, wx, wy)


def fft_gather_cuda(pot, base, wx, wy) -> torch.Tensor:
    nodes = pot.shape[0]
    n = base.shape[0]
    if pot.data_ptr() % 16:
        raise ValueError("pot must be 16-byte aligned (the kernel reads float4 taps)")
    phi = torch.empty((n, 4), dtype=torch.float32, device=pot.device)
    if n:
        _launch("fft_gather", "gather", pot.device, pot.data_ptr(), base.data_ptr(),
                wx.data_ptr(), wy.data_ptr(), phi.data_ptr(), n, nodes)
    return phi


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def kernel_registry() -> dict:
    """name -> dict(plain, cuda, wrapper, source, doc, tpu, replaces).

    ``plain`` is the PyTorch twin, ``cuda`` launches the kernel (CUDA
    tensors only), ``wrapper`` is the device-dispatching entry the port
    calls, ``source`` the CUDA file; ``tpu`` and ``replaces`` name the
    Pallas kernel it replaces as ``file:function`` and ``file:line``.
    """
    return {
        "pairwise_sq_dists": dict(
            plain=_pairwise.pairwise_sq_dists, cuda=pairwise_sq_dists_cuda,
            wrapper=pairwise_sq_dists,
            source="src/repro_torch/csrc/pairwise.cu",
            tpu="src/repro/kernels/pairwise_kernel.py:_pairwise_kernel",
            replaces="src/repro/kernels/pairwise_kernel.py:22",
            doc="KNN distance tile (3xTF32 mma.sync tensor-core product + norm epilogue)"),
        "bsp_search": dict(
            plain=bsp.binary_search_perplexity_plain, cuda=bsp_search_cuda,
            wrapper=bsp_search,
            source="src/repro_torch/csrc/bsp.cu",
            tpu="src/repro/kernels/bsp_kernel.py:_bsp_kernel",
            replaces="src/repro/kernels/bsp_kernel.py:33",
            doc="§3.2: fused per-row perplexity bisection, one warp a row"),
        "morton_encode": dict(
            plain=morton.morton_encode, cuda=morton_encode_cuda,
            wrapper=morton_encode,
            source="src/repro_torch/csrc/morton.cu",
            tpu="src/repro/kernels/morton_kernel.py:_morton_kernel",
            replaces="src/repro/kernels/morton_kernel.py:29",
            doc="Algorithm 1: Morton code formation, one thread a point"),
        "attractive_ell": dict(
            plain=attractive.attractive_forces_ell, cuda=attractive_ell_cuda,
            wrapper=attractive_ell,
            source="src/repro_torch/csrc/attractive.cu",
            tpu="src/repro/kernels/attractive_kernel.py:_attractive_kernel",
            replaces="src/repro/kernels/attractive_kernel.py:26",
            doc="Algorithm 2: attractive forces over the real ELL entries, gather in-kernel"),
        "fft_spread": dict(
            plain=fft_repulsion.spread_to_grid, cuda=fft_spread_cuda,
            wrapper=fft_spread,
            source="src/repro_torch/csrc/spread.cu",
            tpu="src/repro/kernels/interp_kernel.py:_spread_kernel",
            replaces="src/repro/kernels/interp_kernel.py:52",
            doc="FFT repulsion: 3x3 Lagrange spread, lattice bands in clusters, no atomics"),
        "fft_gather": dict(
            plain=fft_repulsion.gather_from_grid, cuda=fft_gather_cuda,
            wrapper=fft_gather,
            source="src/repro_torch/csrc/gather.cu",
            tpu="src/repro/kernels/interp_kernel.py:_gather_kernel",
            replaces="src/repro/kernels/interp_kernel.py:76",
            doc="FFT repulsion: 3x3 Lagrange gather, one thread a point, float4 taps"),
    }


def available_kernels() -> tuple[str, ...]:
    return tuple(sorted(kernel_registry()))

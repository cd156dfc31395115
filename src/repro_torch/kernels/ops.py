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

import torch

from repro_torch.core import _pairwise, attractive, bsp, morton
from repro_torch.kernels import build

LAUNCHES: dict[str, int] = {
    "pairwise_sq_dists": 0, "bsp_search": 0, "morton_encode": 0,
    "attractive_ell": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "pairwise": ("pairwise_sq_dists", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "bsp": ("bsp_search", [_P, _P, _P, _I, _I, _F, _F, _I, _P]),
    "morton": ("morton_encode", [_P, _P, _P, _I, _I, _P]),
    "attractive": ("attractive_ell", [_P, _P, _P, _P, _P, _I, _I, _P]),
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

def attractive_ell(y: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor):
    """Algorithm 2: y [N, 2], cols [N, W] int32, vals [N, W] -> (F [N, 2], KL)."""
    _check("y", y, torch.float32, 2)
    _check("cols", cols, torch.int32, 2)
    _check("vals", vals, torch.float32, 2)
    n, w = cols.shape
    if y.shape != (n, 2) or vals.shape != (n, w):
        raise ValueError(f"expected y [N, 2], cols and vals [N, W]; got y "
                         f"{tuple(y.shape)}, cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}")
    if _device(y=y, cols=cols, vals=vals).type == "cpu":
        return attractive.attractive_forces_ell(y, cols, vals)
    return attractive_ell_cuda(y, cols, vals)


def attractive_ell_cuda(y, cols, vals):
    n, w = cols.shape
    force = torch.empty((n, 2), dtype=torch.float32, device=y.device)
    kl_rows = torch.empty((n,), dtype=torch.float32, device=y.device)
    if n:
        _launch("attractive_ell", "attractive", y.device, y.data_ptr(), cols.data_ptr(),
                vals.data_ptr(), force.data_ptr(), kl_rows.data_ptr(), n, w)
    # per-row partials summed here, as attractive_kernel.py sums them:
    # deterministic, no atomics
    return force, torch.sum(kl_rows)


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
            doc="KNN distance tile (tiled fp32 SIMT product + norm epilogue)"),
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
            doc="Algorithm 2: attractive forces over ELL rows, gather in-kernel"),
    }


def available_kernels() -> tuple[str, ...]:
    return tuple(sorted(kernel_registry()))

"""Binary Search Perplexity (paper §3.2), port of ``repro/core/bsp.py``.

:func:`binary_search_perplexity` goes through the kernel registry's
``bsp_search`` wrapper: a CUDA tensor launches the fused one-warp-per-row
kernel (``csrc/bsp.cu``), a CPU tensor runs
:func:`binary_search_perplexity_plain`, the branch-free vectorised search
of ``repro/core/bsp.py::_binary_search_perplexity_xla``, line for line.
The search variable is beta_i = 1/(2 sigma_i^2).
"""
from __future__ import annotations

import torch


def log_perplexity(perplexity: float) -> float:
    """log(perplexity) rounded as the reference does it: in float32."""
    return float(torch.log(torch.tensor(perplexity, dtype=torch.float32)))


def binary_search_perplexity_plain(d2: torch.Tensor, perplexity: float,
                                   iters: int = 64, tol: float = 1e-5):
    """Conditional similarities p_{j|i} with per-row perplexity == target.

    d2 : [N, K] squared distances to the K nearest neighbors (self excluded)
    Returns (cond_p [N, K], beta [N]).
    """
    dtype = d2.dtype
    n = d2.shape[0]
    log_u = torch.tensor(log_perplexity(perplexity), dtype=dtype, device=d2.device)
    tol_t = torch.tensor(tol, dtype=dtype, device=d2.device)

    # conditioning guards (the same as the reference): shift by the row min
    # and scale by the row mean so beta ~ O(1)
    d2s = d2 - torch.amin(d2, dim=1, keepdim=True)
    scale = torch.clamp_min(torch.mean(d2s, dim=1, keepdim=True), 1e-30)
    d2n = d2s / scale

    def entropy(beta):
        p = torch.exp(-d2n * beta)
        sum_p = torch.clamp_min(torch.sum(p, dim=1, keepdim=True), 1e-30)
        h = torch.log(sum_p) + beta * torch.sum(d2n * p, dim=1, keepdim=True) / sum_p
        return h, p / sum_p

    beta = torch.ones((n, 1), dtype=dtype, device=d2.device)
    bmin = torch.zeros_like(beta)
    bmax = torch.full_like(beta, float("inf"))
    for _ in range(iters):
        h, _ = entropy(beta)
        too_high = h > log_u + tol_t          # entropy too high -> sharpen kernel
        bmin = torch.where(too_high, beta, bmin)
        bmax = torch.where(too_high, bmax, beta)
        up = torch.where(torch.isinf(bmax), beta * 2.0, 0.5 * (beta + bmax))
        down = torch.where(bmin <= 0.0, beta * 0.5, 0.5 * (beta + bmin))
        beta = torch.where(too_high, up, down)
    _, cond_p = entropy(beta)
    return cond_p, (beta / scale)[:, 0]


def binary_search_perplexity(d2: torch.Tensor, perplexity: float,
                             iters: int = 64, tol: float = 1e-5):
    """The search on d2's device: the CUDA kernel or the plain version."""
    from repro_torch.kernels import ops     # lazy: ops imports this module
    return ops.bsp_search(d2, perplexity, iters=iters, tol=tol)


def binary_search_perplexity_chunked(d2: torch.Tensor, perplexity: float,
                                     chunk_size: int, iters: int = 64,
                                     tol: float = 1e-5):
    """Row-chunked :func:`binary_search_perplexity`.

    Every reduction of the search is a row reduction, so chunking over the
    point axis is exact; live transients are bounded by ``[chunk_size, K]``.
    (Eager PyTorch has no retrace to avoid, so the ragged tail is not padded
    as the JAX version pads it.)
    """
    chunk = int(chunk_size)
    if chunk <= 0:
        raise ValueError(f"chunk_size={chunk_size} must be >= 1")
    n = d2.shape[0]
    if chunk >= n:
        return binary_search_perplexity(d2, perplexity, iters, tol)
    parts = [binary_search_perplexity(d2[s:s + chunk], perplexity, iters, tol)
             for s in range(0, n, chunk)]
    return (torch.cat([p for p, _ in parts], dim=0),
            torch.cat([b for _, b in parts], dim=0))


def perplexity_of(cond_p: torch.Tensor) -> torch.Tensor:
    """exp(H) of each row: used to check that the search converged."""
    safe = torch.log(torch.clamp_min(cond_p, 1e-30))
    h = -torch.sum(torch.where(cond_p > 0, cond_p * safe, 0.0), dim=1)
    return torch.exp(h)

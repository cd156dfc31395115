"""Plain PyTorch reference of Barnes-Hut t-SNE's answers.

Straightforward and independent of the program: exact neighbours by brute
force, the perplexity search by plain bisection, the symmetric P as a
sorted list of (row * n + col) keys, and the exact O(N^2) forces, Z and
KL.  Every function takes the working ``dtype``: float64 for the
reference, bfloat16 for the control (the reference put in the program's
place one precision below the configuration's float32).  Sums over rows
and blocks accumulate in float64 unless the working dtype is below
float32, where they stay in it.  Nothing here imports the program.
"""
from __future__ import annotations

import math

import torch

# elements of one [rows, N] block (2**28 float64 = 2 GiB)
BLOCK_ELEMENTS = 2**28


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype in (torch.float32, torch.float64) else dtype


def _block_rows(n: int) -> int:
    return max(1, BLOCK_ELEMENTS // max(n, 1))


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[len(a), len(b)] squared distances |a|^2 + |b|^2 - 2 a.b in a's dtype."""
    d2 = torch.addmm((b * b).sum(1)[None, :], a, b.T, beta=1, alpha=-2)
    d2 += (a * a).sum(1)[:, None]
    return d2.clamp_min_(0)


def knn(x: torch.Tensor, k: int, dtype=torch.float64, rows: torch.Tensor | None = None):
    """Exact k nearest neighbours of ``rows`` (default: every point) among all
    points of ``x`` [n, d], self excluded: (idx [m, k] int64 nearest first,
    d2 [m, k]).  d2 is recomputed from the differences in ``dtype``, not
    taken from the expanded form, so no cancellation reaches it."""
    n = x.shape[0]
    rows = torch.arange(n, device=x.device) if rows is None else rows
    xd = x.to(dtype)
    out_i, out_d = [], []
    step = _block_rows(n)
    for s in range(0, rows.shape[0], step):
        r = rows[s:s + step]
        d2 = sq_dists(xd[r], xd)
        d2[torch.arange(r.shape[0], device=x.device), r] = float("inf")
        _, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        del d2
        diff = xd[r][:, None, :] - xd[idx]
        out_d.append((diff * diff).sum(-1))
        out_i.append(idx)
    return torch.cat(out_i), torch.cat(out_d)


def conditional_p(d2: torch.Tensor, perplexity: float, dtype=torch.float64,
                  iters: int = 100) -> torch.Tensor:
    """p_{j|i} [m, k] whose row entropy is log(perplexity): bisection on
    beta in p ~ exp(-beta d2), d2 shifted by its row minimum (which
    cancels in p)."""
    d2 = d2.to(dtype)
    d2 = d2 - d2.min(dim=1, keepdim=True).values
    target = math.log(perplexity)
    beta = 1.0 / d2.mean(dim=1, keepdim=True).clamp_min(1e-30)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, float("inf"))

    def entropy(b):
        p = torch.exp(-d2 * b)
        s = p.sum(dim=1, keepdim=True)
        return torch.log(s) + b * (d2 * p).sum(dim=1, keepdim=True) / s, p / s

    for _ in range(iters):
        h, _ = entropy(beta)
        too_high = h > target
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(too_high, torch.where(torch.isinf(hi), beta * 2, (lo + hi) / 2),
                           (lo + hi) / 2)
    return entropy(beta)[1]


def symmetrize(idx: torch.Tensor, cond_p: torch.Tensor, n: int):
    """P = (P_cond + P_cond^T) / 2n as (sorted unique keys row * n + col,
    values summing to 1)."""
    m, k = idx.shape
    rows = torch.arange(m, device=idx.device).repeat_interleave(k)
    cols = idx.reshape(-1)
    vals = cond_p.reshape(-1) / (2.0 * n)
    keys = torch.cat([rows * n + cols, cols * n + rows])
    return merge(keys, torch.cat([vals, vals]))


def merge(keys: torch.Tensor, vals: torch.Tensor):
    """Sum the values of equal keys; (sorted unique keys, sums / their total)."""
    uniq, inv = torch.unique(keys, return_inverse=True)
    out = torch.zeros(uniq.shape[0], dtype=vals.dtype, device=vals.device)
    out.index_add_(0, inv, vals)
    return uniq, out / out.sum()


def ell_entries(p_cols: torch.Tensor, p_vals: torch.Tensor, p_len: torch.Tensor):
    """The real entries of ELL rows: (row position [e], col [e], val [e] float64)."""
    w = p_cols.shape[1]
    real = torch.arange(w, device=p_cols.device)[None, :] < p_len[:, None].long()
    rows = torch.arange(p_cols.shape[0], device=p_cols.device)[:, None].expand_as(p_cols)
    return rows[real], p_cols[real].long(), p_vals[real].double()


def l1(keys_a, vals_a, keys_b, vals_b) -> float:
    """sum |A - B| over the union of two sparse matrices' keys."""
    keys = torch.cat([keys_a, keys_b])
    vals = torch.cat([vals_a.double(), -vals_b.double()])
    uniq, inv = torch.unique(keys, return_inverse=True)
    out = torch.zeros(uniq.shape[0], dtype=torch.float64, device=vals.device)
    out.index_add_(0, inv, vals)
    return float(out.abs().sum())


def z_all(y: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Z = sum over i != j of 1 / (1 + |y_i - y_j|^2), over all pairs."""
    n = y.shape[0]
    yd = y.to(dtype)
    acc = acc_dtype(dtype)
    total = torch.zeros((), dtype=acc, device=y.device)
    step = _block_rows(n)
    for s in range(0, n, step):
        d2 = sq_dists(yd[s:s + step], yd)
        r = torch.arange(d2.shape[0], device=y.device)
        d2[r, r + s] = float("inf")
        total += d2.add_(1).reciprocal_().sum(dtype=acc) if acc == torch.float64 \
            else d2.add_(1).reciprocal_().sum()
    return total


def repulsion_rows(y: torch.Tensor, rows: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Unnormalised repulsion sum_j (1 + d_ij^2)^-2 (y_i - y_j) [m, 2] of
    ``rows`` against every point, from the differences in ``dtype``."""
    n = y.shape[0]
    yd = y.to(dtype)
    acc = acc_dtype(dtype)
    out = []
    step = _block_rows(n)
    for s in range(0, rows.shape[0], step):
        r = rows[s:s + step]
        dx = yd[r, 0:1] - yd[None, :, 0]
        dy = yd[r, 1:2] - yd[None, :, 1]
        w = (dx * dx + dy * dy).add_(1).reciprocal_()
        w[torch.arange(r.shape[0], device=y.device), r] = 0
        w2 = w.mul_(w)
        out.append(torch.stack([(w2 * dx).sum(1, dtype=acc) if acc == torch.float64
                                else (w2 * dx).sum(1),
                                (w2 * dy).sum(1, dtype=acc) if acc == torch.float64
                                else (w2 * dy).sum(1)], dim=1))
    return torch.cat(out)


def attraction(y: torch.Tensor, m: int, rows: torch.Tensor, cols: torch.Tensor,
               vals: torch.Tensor, who: torch.Tensor, dtype=torch.float64):
    """sum_j p_ij (1 + d_ij^2)^-1 (y_i - y_j) [m, 2] and sum p_ij log(1 + d_ij^2)
    over the entries (row position ``rows`` in 0..m-1, point ``who[rows]``,
    column ``cols``, value ``vals``)."""
    yd = y.to(dtype)
    acc = acc_dtype(dtype)
    d = yd[who[rows]] - yd[cols]
    d2 = (d * d).sum(1)
    pw = vals.to(dtype) / (1 + d2)
    f = torch.zeros((m, 2), dtype=acc, device=y.device)
    f.index_add_(0, rows, (pw[:, None] * d).to(acc))
    kl_attr = (vals.to(dtype) * torch.log1p(d2)).to(acc).sum()
    return f, kl_attr


def gradient(f_attr, f_rep, z, exaggeration: float):
    """The t-SNE gradient 4 (exaggeration F_attr - F_rep / Z)."""
    return 4.0 * (exaggeration * f_attr - f_rep / z)


def learning_rate(config: dict, n: int) -> float:
    """The configuration's learning rate; "auto" is max(N / early
    exaggeration, 50)."""
    lr = config["learning_rate"]
    return max(n / config["early_exaggeration"], 50.0) if lr == "auto" else float(lr)


def step_velocity(grad, velocity, gains, lr: float, momentum: float, min_gain: float):
    """The momentum-and-gains update's new velocity (scikit-learn's rule)."""
    same = (grad > 0) == (velocity > 0)
    g = torch.where(same, gains * 0.8, gains + 0.2).clamp_min(min_gain)
    return momentum * velocity - lr * g * grad


def kl(vals: torch.Tensor, kl_attr, z) -> float:
    """KL(P || Q) = sum p log p + sum p log(1 + d^2) + log Z."""
    v = vals.double()
    v = v[v > 0]
    return float((v * torch.log(v)).sum() + kl_attr.double() + torch.log(z.double()))


def recall(exact_idx: torch.Tensor, support_cols: torch.Tensor,
           support_len: torch.Tensor) -> float:
    """Mean over rows of the share of each row's exact neighbours found among
    its first ``support_len`` support columns."""
    w = support_cols.shape[1]
    real = torch.arange(w, device=support_cols.device)[None, :] < support_len[:, None].long()
    found = 0
    step = max(1, 2**27 // max(exact_idx.shape[1] * w, 1))
    for s in range(0, exact_idx.shape[0], step):
        e = exact_idx[s:s + step, :, None]
        c = torch.where(real[s:s + step], support_cols[s:s + step].long(), -1)[:, None, :]
        found += int((e == c).any(-1).sum())
    return found / exact_idx.numel()

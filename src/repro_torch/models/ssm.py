"""Mamba-2 (SSD) block: port of ``repro/models/ssm.py``.

Recurrence per head h with state [N, P]:
    S_t = a_t * S_{t-1} + dt_t * (B_t (x) x_t)      a_t = exp(dt_t * A_h)
    y_t = C_t^T S_t + D_h * x_t

Prefill and training run the chunked form (:func:`_ssd_chunked`, a loop
over chunks carrying the inter-chunk state; within a chunk an
attention-like quadratic form masked by cumulative decay), decode the
one-step recurrence.  Plain PyTorch, as the reference is plain ``jnp``.
The decode path writes the cache (``state``, ``conv``) **in place** and
returns it, as the attention blocks do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import init_dense, rms_norm


def init_mamba(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    """One block's parameters, the reference's dict.  ``dt_bias``,
    ``a_log`` and ``d_skip`` are float32 whatever ``dtype`` is, as the
    reference's."""
    s, d, dev = cfg.ssm, cfg.d_model, gen.device
    din = s.expand * d
    h = din // s.head_dim
    return {
        "in_proj": init_dense(gen, (d, 2 * din), dtype),                # x, z
        "w_bc": init_dense(gen, (d, 2 * s.state_dim), dtype),           # B, C
        "w_dt": init_dense(gen, (d, h), dtype),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "a_log": torch.zeros((h,), dtype=torch.float32, device=dev),    # A = -exp(a_log)
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "conv": init_dense(gen, (s.conv_width, din), dtype, scale=0.5),
        "norm": torch.zeros((din,), dtype=dtype, device=dev),
        "out_proj": init_dense(gen, (din, d), dtype,
                               scale=din**-0.5 / (2 * cfg.n_layers) ** 0.5),
    }


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype, device=None) -> dict:
    """One layer's decode cache: the float32 ``state [B, H, N, P]`` and the
    conv's last W - 1 inputs ``conv [B, W - 1, d_inner]`` in ``dtype``."""
    s = cfg.ssm
    din = s.expand * cfg.d_model
    return {
        "state": torch.zeros((batch, din // s.head_dim, s.state_dim, s.head_dim),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, din), dtype=dtype, device=device),
    }


def _causal_conv(xs: torch.Tensor, conv_w: torch.Tensor, conv_state: torch.Tensor | None = None):
    """Depthwise causal conv of width W: xs [B, T, din], conv_w [W, din];
    ``conv_state`` [B, W - 1, din] seeds the positions before the first
    (zeros without it).  Returns (out, the last W - 1 inputs).  A Python
    ``sum`` of the W shifted products in the reference's order, so bf16
    rounds as it does (and no cuDNN convolution, which may take TF32)."""
    w, t = conv_w.shape[0], xs.shape[1]
    if conv_state is None:
        pad = torch.zeros((xs.shape[0], w - 1, xs.shape[2]), dtype=xs.dtype, device=xs.device)
    else:
        pad = conv_state
    xp = torch.cat([pad, xs], dim=1)
    out = sum(xp[:, i:i + t, :] * conv_w[i][None, None, :] for i in range(w))
    return out, (xp[:, -(w - 1):, :] if w > 1 else None)


def _ssd_chunk(state, xq, bq, cq, dq, lq):
    """One chunk (the reference's ``per_chunk``): xq [B, Q, H, P], bq/cq
    [B, Q, N], dq (dt) and lq (dt * A) [B, Q, H], all float32."""
    q = xq.shape[1]
    cla = torch.cumsum(lq, dim=1)                                  # [B, Q, H]
    # inter-chunk: y_i += C_i . (exp(cla_i) * S_in)
    y_inter = torch.einsum("bqn,bhnp->bqhp", cq, state) * torch.exp(cla)[..., None]
    # intra-chunk quadratic form, the diagonal included
    g = torch.einsum("bqn,bkn->bqk", cq, bq)                       # [B, Q, Q]
    mask = (torch.arange(q, device=xq.device)[:, None]
            >= torch.arange(q, device=xq.device)[None, :])[None, :, :, None]
    dd = torch.where(mask, cla[:, :, None, :] - cla[:, None, :, :], -torch.inf)   # [B, Q, K, H]
    w = torch.where(mask, torch.exp(dd) * g[..., None], 0.0) * dq[:, None, :, :]
    y_intra = torch.einsum("bqkh,bkhp->bqhp", w, xq)
    # S_out = exp(cla_Q) * S_in + sum_j exp(cla_Q - cla_j) dt_j B_j (x) x_j
    decay_out = torch.exp(cla[:, -1:, :] - cla)                    # [B, Q, H]
    sb = torch.einsum("bqh,bqn,bqhp->bhnp", decay_out * dq, bq, xq)
    state = torch.exp(cla[:, -1, :])[:, :, None, None] * state + sb
    return state, y_inter + y_intra


def _ssd_chunked(xh, bt, ct, dt, a_log, chunk: int):
    """The chunked SSD scan from a zero state: xh [B, T, H, P], bt/ct [B,
    T, N], dt [B, T, H] (after the softplus), a_log [H].  Returns (y [B,
    T, H, P] float32, the final state [B, H, N, P]).  A Python loop over
    chunks of ``chunk``; the last runs short where the reference pads it
    with dt = 0 (the same values).

    One departure from ``repro/models/ssm.py:95-97``: the reference takes
    ``exp(dd)`` over the whole [Q, Q] square and masks afterwards.  Above
    the diagonal ``dd`` is a positive sum of ``|dt * A|`` over up to Q - 1
    steps, which passes float32's ``exp`` limit (88.7) at zamba2's chunk
    of 128 once dt is ~0.7 (A = -1 at init): the forward is finite (the
    mask picks 0), the backward ``0 * inf = NaN``.  The port masks ``dd``
    to -inf before the ``exp``: the forward is the same, value for value,
    and the gradient stays finite."""
    b, t, h, p = xh.shape
    q = min(chunk, t)
    a = -torch.exp(a_log)                                          # [H]
    loga = dt * a[None, None, :]                                   # [B, T, H] log-decay
    state = torch.zeros((b, h, bt.shape[-1], p), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(0, t, q):
        sl = slice(c, c + q)
        state, y = _ssd_chunk(state, xh[:, sl].float(), bt[:, sl].float(), ct[:, sl].float(),
                              dt[:, sl].float(), loga[:, sl].float())
        ys.append(y)
    return torch.cat(ys, dim=1), state


def mamba_block(params, x: torch.Tensor, cfg: ArchConfig, *, cache: dict | None = None):
    """x [B, T, D] -> (out, cache).  Without a cache the chunked scan; with
    one (T = 1) the single-step recurrence, whose output reads the state
    *after* the update; ``state`` and ``conv`` written in place."""
    s = cfg.ssm
    b, t, d = x.shape
    din = s.expand * d
    h = din // s.head_dim
    xs, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)
    xs, new_conv = _causal_conv(xs, params["conv"], None if cache is None else cache["conv"])
    xs = F.silu(xs)
    bt, ct = torch.chunk(x @ params["w_bc"], 2, dim=-1)
    dt = F.softplus(x.float() @ params["w_dt"].float() + params["dt_bias"][None, None, :])
    xh = xs.reshape(b, t, h, s.head_dim)

    if cache is None:
        y, _ = _ssd_chunked(xh, bt, ct, dt, params["a_log"], s.chunk)
    else:
        a = -torch.exp(params["a_log"])
        decay = torch.exp(dt[:, 0] * a[None, :])                   # [B, H]
        sb = torch.einsum("bh,bn,bhp->bhnp", dt[:, 0], bt[:, 0].float(), xh[:, 0].float())
        state = decay[:, :, None, None] * cache["state"] + sb
        y = torch.einsum("bn,bhnp->bhp", ct[:, 0].float(), state)[:, None]
        cache["state"].copy_(state)
        cache["conv"].copy_(new_conv)

    y = y + params["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(b, t, din).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"], cache

"""RWKV-6 "Finch" block: port of ``repro/models/rwkv.py``.

Per head (dim P), state S [P_k, P_v]:
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t         w_t = exp(-exp(wdec_t))
    o_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
with w_t data-dependent through a low-rank MLP.  As in the reference (and
unlike upstream RWKV-6) the token shift mixes with static ``mix`` vectors
and the WKV output is normed by ``rms_norm`` over the whole ``d_model``.

Two WKV forms, as the reference picks them: the chunked parallel form
(:func:`_wkv_chunked_parallel`) for ``loss_fn`` and ``prefill`` when
``cfg.rwkv.wkv_mode == "chunked"``, the sequential recurrence
(:func:`_wkv_scan`) for decode and anything else with a cache.  Both are
plain PyTorch, as the reference's are plain ``jnp``.  The decode path
writes the cache (``state``, ``x_time``, ``x_chan``) **in place** and
returns it, as the attention blocks do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import init_dense, rms_norm


def init_rwkv(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    """One block's parameters, the reference's dict: ``time`` (mixes, the
    r/k/v/g/o projections, the decay's base ``w0`` and low-rank MLP, the
    bonus ``u``, ``ln_x``) and ``channel`` (mixes, the squared-ReLU FFN).
    ``w0`` and ``u`` are float32 whatever ``dtype`` is, as the reference's."""
    d, dev = cfg.d_model, gen.device
    lora = max(32, d // 32)
    return {
        "time": {
            "mix": 0.5 * torch.ones((5, d), dtype=dtype, device=dev),   # r, k, v, w, g
            "wr": init_dense(gen, (d, d), dtype),
            "wk": init_dense(gen, (d, d), dtype),
            "wv": init_dense(gen, (d, d), dtype),
            "wg": init_dense(gen, (d, d), dtype),
            "w0": torch.full((d,), -6.0, dtype=torch.float32, device=dev),
            "w_lora_a": init_dense(gen, (d, lora), dtype, scale=0.01),
            "w_lora_b": init_dense(gen, (lora, d), dtype, scale=0.01),
            "u": torch.zeros((d,), dtype=torch.float32, device=dev),
            "wo": init_dense(gen, (d, d), dtype, scale=d**-0.5 / (2 * cfg.n_layers) ** 0.5),
            "ln_x": torch.zeros((d,), dtype=dtype, device=dev),
        },
        "channel": {
            "mix": 0.5 * torch.ones((2, d), dtype=dtype, device=dev),   # k, r
            "wk": init_dense(gen, (d, cfg.d_ff), dtype),
            "wv": init_dense(gen, (cfg.d_ff, d), dtype,
                             scale=cfg.d_ff**-0.5 / (2 * cfg.n_layers) ** 0.5),
            "wr": init_dense(gen, (d, d), dtype),
        },
    }


def init_rwkv_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype, device=None) -> dict:
    """One layer's decode cache: the float32 WKV ``state [B, H, P, P]`` and
    the two token-shift rows ``x_time``, ``x_chan [B, D]`` in ``dtype``."""
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    return {
        "state": torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32, device=device),
        "x_time": torch.zeros((batch, d), dtype=dtype, device=device),
        "x_chan": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor | None = None) -> torch.Tensor:
    """The previous token's features; ``last`` [B, D] seeds position -1
    (the decode cache), zeros without it."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _checkpointed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward when
    gradients are on (the reference's ``jax.checkpoint`` of a chunk)."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args
                                       if isinstance(a, torch.Tensor)):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _wkv_steps(s, r, k, v, w, u):
    """The recurrence over the steps of r, k, v, w [B, T, H, P] (float32)
    from state s; returns (state, outputs [B, T, H, P])."""
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]                 # [B, H, P, P]
        outs.append(torch.einsum("bhp,bhpq->bhq", r[:, t], s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return s, torch.stack(outs, dim=1)


def _wkv_scan(r, k, v, w, u, state, chunk: int = 64):
    """The sequential WKV: r, k, v [B, T, H, P]; w [B, T, H, P] decay in
    (0, 1); u [H, P]; state [B, H, P, P] float32.  Returns (out [B, T, H,
    P] float32, state).  In float32 throughout; a loop over time, each
    ``chunk`` of steps rematerialised in the backward (only the chunk
    carries are kept), as the reference's two-level scan.  Its padding
    (decay 1, k = 0) leaves the state unchanged, so the port needs none."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    outs = []
    for c in range(0, r.shape[1], chunk):
        sl = slice(c, c + chunk)
        state, out = _checkpointed(_wkv_steps, state, r[:, sl], k[:, sl], v[:, sl], w[:, sl], u)
        outs.append(out)
    return torch.cat(outs, dim=1), state


def _wkv_chunk(s_in, rq, kq, vq, wq, u, out_dtype: torch.dtype):
    """One chunk of the parallel form (the reference's ``per_chunk``):
    inputs [B, Q, H, P] cast to float32; returns (state out, output in
    ``out_dtype``)."""
    rq, kq, vq, wq = (a.float() for a in (rq, kq, vq, wq))
    q = rq.shape[1]
    tri = (torch.arange(q, device=rq.device)[:, None]
           > torch.arange(q, device=rq.device)[None, :])[None, None]
    logw = torch.log(torch.clamp(wq, min=1e-38))
    lc = torch.cumsum(logw, dim=1)                              # L_t (inclusive)
    rdq = rq * torch.exp(torch.clamp(lc - logw, -50.0, 50.0))   # r_t exp(L_{t-1})
    kdq = kq * torch.exp(torch.clamp(-lc, -50.0, 50.0))         # k_s exp(-L_s)
    y_inter = torch.einsum("bqhk,bhkv->bqhv", rdq, s_in)
    att = torch.einsum("bqhk,bshk->bhqs", rdq, kdq)
    att = torch.where(tri, att, 0.0)                            # strictly lower
    y_intra = torch.einsum("bhqs,bshv->bqhv", att, vq)
    y_diag = torch.sum(rq * u[None, None] * kq, -1, keepdim=True) * vq
    l_q = lc[:, -1:, :, :]                                      # L_Q
    k_out = kq * torch.exp(torch.clamp(l_q - lc, -50.0, 50.0))
    s_out = torch.exp(torch.clamp(l_q[:, 0], -50.0, 50.0))[..., :, None] * s_in \
        + torch.einsum("bshk,bshv->bhkv", k_out, vq)
    return s_out, (y_inter + y_intra + y_diag).to(out_dtype)


def _wkv_chunked_parallel(r, k, v, w, u, state, chunk: int = 16):
    """The chunked parallel WKV (same signature as :func:`_wkv_scan`):
    within a chunk the recurrence unrolls to an attention-like quadratic
    form with per-channel decays in log space, so the state is touched
    once a chunk.  A Python loop over chunks, never over tokens; each
    chunk rematerialised in the backward when gradients are on.

    As the reference: exponents clamped to +-50; ``log(max(w, 1e-38))``;
    each chunk's output cast to ``r``'s dtype inside the chunk (the scan's
    stays float32).  1e-38 lies below float32's smallest normal: where
    ``w`` underflows (decay exponent ``dec > ~4.5``) the port's floor is
    the subnormal 1e-38 and the logs stay finite, while XLA on the CPU
    flushes subnormals, so the reference's floor is 0 and its output NaN
    (``tests/test_torch_rwkv.py`` records both).  The reference pads the
    last chunk (decay 1, r = k = v = 0); the port runs it short, which
    gives the same values."""
    q = min(chunk, r.shape[1])
    outs = []
    for c in range(0, r.shape[1], q):
        sl = slice(c, c + q)
        state, out = _checkpointed(_wkv_chunk, state, r[:, sl], k[:, sl], v[:, sl], w[:, sl],
                                   u, r.dtype)
        outs.append(out)
    return torch.cat(outs, dim=1), state


def rwkv_time_mix(p, x: torch.Tensor, cfg: ArchConfig, cache: dict | None = None):
    """The time-mixing half: token shift, r/k/v/g, the data-dependent
    decay, the WKV, ``ln_x`` and the gated output projection.  With a
    cache, reads and writes ``state`` and ``x_time`` (the block's input's
    last row) in place."""
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    h = d // hd
    b, t, _ = x.shape
    xprev = _token_shift(x, None if cache is None else cache["x_time"])
    mix = p["mix"]
    xr = x + (xprev - x) * mix[0]
    xk = x + (xprev - x) * mix[1]
    xv = x + (xprev - x) * mix[2]
    xw = x + (xprev - x) * mix[3]
    xg = x + (xprev - x) * mix[4]
    r = (xr @ p["wr"]).reshape(b, t, h, hd)
    k = (xk @ p["wk"]).reshape(b, t, h, hd)
    v = (xv @ p["wv"]).reshape(b, t, h, hd)
    g = F.silu(xg @ p["wg"])
    # data-dependent decay: w = exp(-exp(w0 + lora(xw))), in float32
    dec = p["w0"][None, None, :] + (torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).float()
    w = torch.exp(-torch.exp(dec)).reshape(b, t, h, hd)
    u = p["u"].reshape(h, hd)
    if cache is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    else:
        state = cache["state"]
    if cache is None and cfg.rwkv.wkv_mode == "chunked":
        out, new_state = _wkv_chunked_parallel(r, k, v, w, u, state)
    else:
        out, new_state = _wkv_scan(r, k, v, w, u, state)
    out = rms_norm(out.reshape(b, t, d).to(x.dtype), p["ln_x"], cfg.norm_eps)
    out = (out * g) @ p["wo"]
    if cache is not None:
        cache["state"].copy_(new_state)
        cache["x_time"].copy_(x[:, -1, :])
    return out


def rwkv_channel_mix(p, x: torch.Tensor, cfg: ArchConfig, cache: dict | None = None):
    """The channel-mixing half (squared-ReLU FFN gated by a sigmoid); with a
    cache, reads and writes ``x_chan`` (its own input's last row) in place."""
    xprev = _token_shift(x, None if cache is None else cache["x_chan"])
    xk = x + (xprev - x) * p["mix"][0]
    xr = x + (xprev - x) * p["mix"][1]
    k = torch.square(F.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    if cache is not None:
        cache["x_chan"].copy_(x[:, -1, :])
    return out


def rwkv_block(params, x: torch.Tensor, cfg: ArchConfig, *, cache: dict | None = None):
    """x [B, T, D] -> (x, cache): time mix, then channel mix, each added
    to the residual.  The cache (one layer's views) is written in place."""
    x = x + rwkv_time_mix(params["time"], x, cfg, cache)
    x = x + rwkv_channel_mix(params["channel"], x, cfg, cache)
    return x, cache

"""Shared model building blocks: norms, RoPE, SwiGLU, attention cores: port
of ``repro/models/layers.py``, ``chunked_attention``'s custom VJP as a
``torch.autograd.Function``.

Plain PyTorch that mirrors the reference's ``jnp`` operation for operation,
including where it casts: the reference computes these outside any Pallas
kernel, so the port has no kernel here either.  Weights keep the
reference's ``[in, out]`` layout (``x @ w``).

Under an active mesh whose model axis divides the hidden width,
:func:`swiglu` is tensor-parallel as the reference's parameter rules shard
it (``w1``/``w3`` by columns, ``w2`` by rows over ``ffn``): model shard m
computes its block on its device and one psum follows ``w2``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import broadcast, reduce_sum
from repro_torch.distributed.sharding import shard_group


class _NoDraws:
    """Stands in for the generator on the abstract path: its ``device`` is
    meta, where :func:`init_dense` draws nothing."""

    device = torch.device("meta")


NO_DRAWS = _NoDraws()


def init_dense(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], times ``scale`` (default
    ``fan_in ** -0.5``), drawn in float32 on ``gen``'s device and cast to
    ``dtype``, as the reference draws it (no correction for the
    truncation).  The draws cannot be the reference's: parity tests carry
    its parameters across (``convert.lm_params_from_numpy``).  On the
    abstract path (``gen`` is :data:`NO_DRAWS`) an empty meta tensor of
    the shape and dtype, nothing drawn."""
    shape = tuple(shape)
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in**-0.5
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + scale`` (scales start at zero),
    cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    group = shard_group("ffn", w1.shape[-1])
    if group is None:
        return (F.silu(x @ w1) * (x @ w3)) @ w2
    f = w1.shape[-1] // group.size
    parts = [(F.silu(xm @ a.to(dev, non_blocking=True)) * (xm @ b.to(dev, non_blocking=True)))
             @ c.to(dev, non_blocking=True)
             for dev, xm, a, b, c in zip(group.devices, broadcast(group, x), w1.split(f, dim=-1),
                                         w3.split(f, dim=-1), w2.split(f, dim=0))]
    return reduce_sum(parts, x.device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=dtype, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, dh] (dh even), positions: [..., S] int.  Rotates the
    split halves ``x[..., :dh/2]`` and ``x[..., dh/2:]`` (not interleaved
    pairs) in float32."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)
    angles = positions[..., None].float() * freqs               # [..., S, dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, dh] -> [B, S, Hkv * n_rep, dh]: query head j reads kv
    head j // n_rep."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain softmax attention — reference path and decode path.

    q: [B, Sq, H, dh], k/v: [B, Skv, Hkv, dh].  Logits and softmax in
    float32 (masked logits are -1e30); the probabilities are cast to q's
    dtype before the product with V.
    """
    h, hkv = q.shape[2], k.shape[2]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where((kpos <= qpos)[None, None], logits, -1e30)
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                      chunk: int = 512) -> torch.Tensor:
    """Flash attention (an online softmax over KV chunks) with the
    reference's custom backward.

    The forward never materialises the [Sq, Skv] score matrix; the
    backward recomputes each chunk's probabilities from the saved
    ``(out, lse)`` instead of differentiating through the chunk loop,
    which would save the float32 accumulator of every chunk."""
    return _FlashAttention.apply(q, k, v, causal, chunk)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_make_flash``: forward ``_fa_forward``, which
    saves ``(q, k, v, out, lse)``; backward :func:`_fa_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int):
        out, lse = _fa_forward(q, k, v, causal, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.chunk = causal, chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_fa_backward(q, k, v, out, lse, dout, ctx.causal, ctx.chunk), None, None)


def _pad_kv(k: torch.Tensor, chunk: int) -> tuple[torch.Tensor, int]:
    skv = k.shape[1]
    pad = (-skv) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
    return k, skv


def _fa_forward(q, k, v, causal: bool, chunk: int):
    """(out [B, Sq, H, dh] in q's dtype, lse [B, H, Sq] float32).  The KV
    length is padded to a multiple of ``chunk``; the padding and (if
    causal) ``kpos > qpos`` are masked.  q is scaled in float32 and each
    chunk of K and V is cast up to float32."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    n_rep = h // hkv
    k, kv_valid = _pad_kv(k, chunk)
    v, _ = _pad_kv(v, chunk)
    n_chunks = k.shape[1] // chunk
    scale = dh**-0.5
    qf = q.float() * scale
    qpos = torch.arange(sq, device=q.device)[:, None]

    m = torch.full((b, h, sq), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        kc = _repeat_kv(k[:, c * chunk:(c + 1) * chunk], n_rep).float()
        vc = _repeat_kv(v[:, c * chunk:(c + 1) * chunk], n_rep).float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kc)
        kpos = c * chunk + torch.arange(chunk, device=q.device)[None, :]
        valid = kpos < kv_valid
        if causal:
            valid = valid & (kpos <= qpos)
        logits = torch.where(valid[None, None], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).transpose(1, 2).to(q.dtype)
    lse = m + torch.log(l_safe)
    return out, lse


def _fa_backward(q, k, v, out, lse, dout, causal: bool, chunk: int):
    """(dq, dk, dv) in q's, k's and v's dtypes: the reference's ``bwd``
    line for line.  ``delta = rowsum(dout * out)``; per KV chunk the
    probabilities ``p = exp(s - lse)`` (masked like the forward), ``dv``,
    ``dp`` and ``ds = p * (dp - delta) * scale``; ``dq`` accumulates in
    float32 and each chunk's ``dk``/``dv`` is summed over the GQA group
    onto its KV head and cast to K's (V's) dtype; the padding is cut off.
    Never materialises [Sq, Skv]: a chunk's [B, H, Sq, chunk] at a time."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    n_rep = h // hkv
    kp, kv_valid = _pad_kv(k, chunk)
    vp, _ = _pad_kv(v, chunk)
    n_chunks = kp.shape[1] // chunk
    scale = dh**-0.5
    qf = q.float()
    doutf = dout.float()
    delta = torch.einsum("bqhd,bqhd->bhq", doutf, out.float())        # [B, H, Sq]
    lse_safe = torch.where(torch.isfinite(lse), lse, 0.0)
    qpos = torch.arange(sq, device=q.device)[:, None]

    dq = torch.zeros((b, sq, h, dh), dtype=torch.float32, device=q.device)
    dk_chunks, dv_chunks = [], []
    for c in range(n_chunks):
        kc = _repeat_kv(kp[:, c * chunk:(c + 1) * chunk], n_rep).float()
        vc = _repeat_kv(vp[:, c * chunk:(c + 1) * chunk], n_rep).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
        kpos = c * chunk + torch.arange(chunk, device=q.device)[None, :]
        valid = kpos < kv_valid
        if causal:
            valid = valid & (kpos <= qpos)
        p = torch.where(valid[None, None], torch.exp(s - lse_safe[..., None]), 0.0)
        dv_c = torch.einsum("bhqk,bqhd->bkhd", p, doutf)
        dp = torch.einsum("bqhd,bkhd->bhqk", doutf, vc)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kc)
        dk_c = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        # sum the GQA query-head group back onto the shared KV head
        dk_chunks.append(dk_c.reshape(b, chunk, hkv, n_rep, dh).sum(3).to(k.dtype))
        dv_chunks.append(dv_c.reshape(b, chunk, hkv, n_rep, dh).sum(3).to(v.dtype))
    dk = torch.cat(dk_chunks, dim=1)[:, :k.shape[1]]
    dv = torch.cat(dv_chunks, dim=1)[:, :v.shape[1]]
    return dq.to(q.dtype), dk, dv

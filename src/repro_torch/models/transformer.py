"""Layer stacks: port of ``repro/models/transformer.py``: the dense, MoE
and enc-dec (``decoder_cross``) block stacks and the hybrid (zamba2-like)
stack.

The reference scans a stacked ``[L, ...]`` parameter pytree with optional
remat; the port keeps one parameter dict a layer and loops over them in
Python.  ``cfg.remat`` wraps each block in
``torch.utils.checkpoint.checkpoint`` when gradients are on (the
reference's ``jax.checkpoint`` of the scan body): the backward keeps each
block's input and recomputes the rest, the MoE block's aux loss among its
outputs.  :func:`remat_call` makes each block recompute once, on one thread
(see :class:`_RecomputeHere`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import attention_block, init_attention, init_kv_cache
from repro_torch.models.layers import init_dense, rms_norm, swiglu
from repro_torch.models.mla import init_mla, mla_block
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.ssm import init_mamba, init_ssm_cache, mamba_block


class _RecomputeHere(torch.autograd.Function):
    """The identity, whose backward reads a tensor that the enclosing
    checkpoint saved.  As a rematerialised block's last op its backward
    runs before any other of the block's, on its output's device thread,
    and recomputes the block there.  Without it, where a block's saved
    tensors lie on several cards (the tensor-parallel blocks of a mesh that
    spans cards), autograd's device threads may each start the recompute
    at once, and the non-reentrant checkpoint's recompute is not
    thread-safe: the threads' saved tensors interleave."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors                       # unpacking it recomputes the block
        return g


def remat_call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` rematerialised in the backward (a
    non-reentrant ``checkpoint``), recomputed once, on the thread of its
    output's device (its first output's when it returns a tuple)."""
    def body(*a, **kw):
        out = fn(*a, **kw)
        if isinstance(out, tuple):
            return (_RecomputeHere.apply(out[0]), *out[1:])
        return _RecomputeHere.apply(out)

    return checkpoint(body, *args, use_reentrant=False, **kwargs)


def init_block(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, *,
               kind: str = "dense", d_ff: int | None = None) -> dict:
    """One block's parameters, the reference's dict: ln1, attn (GQA {wq,
    wk, wv, wo}, or MLA's when ``cfg.attention == "mla"``), for
    ``kind="decoder_cross"`` ln_cross and cross (a GQA dict), then ln2 and
    mlp: a SwiGLU {w1, w3, w2} of width ``d_ff`` (default ``cfg.d_ff``),
    the MoE's dict for ``kind="moe"``.  The norm scales start at zero."""
    d = cfg.d_model
    p = {"ln1": torch.zeros((d,), dtype=dtype, device=gen.device),
         "attn": (init_mla if cfg.attention == "mla" else init_attention)(gen, cfg, dtype)}
    if kind == "decoder_cross":
        p["ln_cross"] = torch.zeros((d,), dtype=dtype, device=gen.device)
        p["cross"] = init_attention(gen, cfg, dtype)
    p["ln2"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    if kind == "moe":
        p["mlp"] = init_moe(gen, cfg, dtype)
    else:
        ff = d_ff or cfg.d_ff
        p["mlp"] = {
            "w1": init_dense(gen, (d, ff), dtype),
            "w3": init_dense(gen, (d, ff), dtype),
            "w2": init_dense(gen, (ff, d), dtype, scale=ff**-0.5 / (2 * cfg.n_layers) ** 0.5),
        }
    return p


def block_forward(params, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, *,
                  kind: str = "dense", cache=None, cache_pos=None, cross_kv=None,
                  causal: bool = True, use_rope: bool = True):
    """One block: self-attention (GQA, causal and with RoPE unless told
    otherwise, or MLA), for ``kind="decoder_cross"`` the cross-attention
    over ``cross_kv`` (the encoder's (k, v), required: the reference falls
    through to self-attention with the cross weights when it is None), then
    the SwiGLU or the MoE.  Returns (x, aux_loss): the MoE's float32 aux
    loss, None for the other kinds."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if cfg.attention == "mla":
        attn_out, _ = mla_block(params["attn"], h, positions, cfg, cache=cache,
                                cache_pos=cache_pos)
    else:
        attn_out, _ = attention_block(params["attn"], h, positions, cfg, causal=causal,
                                      use_rope=use_rope, cache=cache, cache_pos=cache_pos)
    x = x + attn_out
    if kind == "decoder_cross":
        if cross_kv is None:
            raise ValueError("a decoder_cross block needs the encoder's cross_kv")
        h = rms_norm(x, params["ln_cross"], cfg.norm_eps)
        x = x + attention_block(params["cross"], h, positions, cfg, cross_kv=cross_kv)[0]
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    if kind == "moe":
        mlp_out, aux = moe_block(params["mlp"], h, cfg)
        return x + mlp_out, aux["aux_loss"]
    return x + swiglu(h, **params["mlp"]), None


def init_stack(gen: torch.Generator, cfg: ArchConfig, n_layers: int, dtype: torch.dtype, *,
               kind: str = "dense", d_ff: int | None = None) -> list[dict]:
    return [init_block(gen, cfg, dtype, kind=kind, d_ff=d_ff) for _ in range(n_layers)]


def stack_forward(params, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, *,
                  kind: str = "dense", cache=None, cache_pos=None, cross_kv=None,
                  causal: bool = True, use_rope: bool = True):
    """Loop over the block dicts; returns (x, the blocks' summed aux loss,
    a float32 scalar).  ``cache`` is the stacked cache, a dict of
    ``[L, B, S, ...]`` tensors (``{k, v}``, or MLA's ``{ckv, krope}``):
    layer i reads and writes its views ``cache[name][i]`` in place; or
    None.  ``cross_kv`` is the per-layer encoder (k, v) of a
    ``decoder_cross`` stack: a pair whose members layer i indexes
    (``[L, B, F, Hkv, dh]`` tensors or lists of ``[B, F, Hkv, dh]``).
    Each block is rematerialised in the backward when ``cfg.remat`` and
    gradients are on (serving runs under ``no_grad``, so never there)."""
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cache is None and cfg.remat and torch.is_grad_enabled()
    for i, layer in enumerate(params):
        kw = dict(kind=kind, causal=causal, use_rope=use_rope,
                  cross_kv=None if cross_kv is None else (cross_kv[0][i], cross_kv[1][i]))
        if remat:
            x, aux = remat_call(block_forward, layer, x, positions, cfg, **kw)
        else:
            layer_cache = None if cache is None else {n: c[i] for n, c in cache.items()}
            x, aux = block_forward(layer, x, positions, cfg, cache=layer_cache,
                                   cache_pos=cache_pos, **kw)
        if aux is not None:
            aux_sum = aux_sum + aux
    return x, aux_sum


# ---------------------------------------------------------------------------
# hybrid (zamba2-like): Mamba-2 layers + one shared attention block
# ---------------------------------------------------------------------------

def init_hybrid(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    """``{"mamba": L Mamba-2 block dicts, "shared": one dense block of width
    cfg.ssm.shared_d_ff}`` (no ``shared`` when ``shared_stride`` is 0).
    The reference stacks ``mamba`` by ``vmap``; the port keeps the list."""
    p = {"mamba": [init_mamba(gen, cfg, dtype) for _ in range(cfg.n_layers)]}
    if cfg.ssm.shared_stride:
        p["shared"] = init_block(gen, cfg, dtype, kind="dense", d_ff=cfg.ssm.shared_d_ff)
    return p


def n_shared_apps(cfg: ArchConfig) -> int:
    """How often the shared block runs: after each Mamba layer whose index
    is a multiple of ``shared_stride``."""
    s = cfg.ssm.shared_stride
    return 0 if not s else (cfg.n_layers + s - 1) // s


def _hybrid_layer(layer, shared, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                  idx: int, cache=None, cache_pos=None):
    """Mamba layer ``idx``, then the shared block when ``idx % stride ==
    0`` (the reference's ``lax.cond``), reading and writing KV cache
    ``idx // stride`` of ``cache["shared"]`` in place."""
    x, _ = mamba_block(layer, x, cfg,
                       cache=None if cache is None else {n: c[idx] for n, c in
                                                         cache["ssm"].items()})
    stride = cfg.ssm.shared_stride
    if stride and idx % stride == 0:
        app = idx // stride
        kv = None if cache is None else {n: c[app] for n, c in cache["shared"].items()}
        x, _ = block_forward(shared, x, positions, cfg, kind="dense", cache=kv,
                             cache_pos=cache_pos)
    return x


def hybrid_forward(params, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, *,
                   cache=None, cache_pos=None):
    """The Mamba layers in order, the shared block after every
    ``shared_stride``-th.  ``cache`` is ``{"ssm": {state [L, B, H, N, P],
    conv [L, B, W - 1, d_inner]}, "shared": {k, v [apps, B, S, Hkv, dh]}
    (or () without a shared block)}``, written in place; or None.  Each
    layer (with its shared application) is rematerialised in the backward
    when ``cfg.remat`` and gradients are on.  Returns (x, cache)."""
    remat = cache is None and cfg.remat and torch.is_grad_enabled()
    shared = params.get("shared")
    for idx, layer in enumerate(params["mamba"]):
        if remat:
            x = remat_call(_hybrid_layer, layer, shared, x, positions, cfg, idx)
        else:
            x = _hybrid_layer(layer, shared, x, positions, cfg, idx, cache, cache_pos)
    return x, cache


def stacked_cache(depth: int, layer: dict, device) -> dict:
    """Zeros of ``depth`` stacked copies of one layer's cache (a dict of
    tensors, e.g. on the meta device), each leaf in its own dtype."""
    return {k: torch.zeros((depth, *v.shape), dtype=v.dtype, device=device)
            for k, v in layer.items()}


def init_hybrid_cache(cfg: ArchConfig, batch: int, seq: int, dtype: torch.dtype,
                      device=None) -> dict:
    """Zeros: the Mamba layers' stacked caches (``state`` float32, ``conv``
    in ``dtype``) and the shared block's stacked KV caches, one an
    application, in ``dtype`` (``()`` without a shared block)."""
    apps = n_shared_apps(cfg)
    return {"ssm": stacked_cache(cfg.n_layers, init_ssm_cache(cfg, batch, dtype, device="meta"),
                                 device),
            "shared": stacked_cache(apps, init_kv_cache(cfg, batch, seq, dtype, device="meta"),
                                    device) if apps else ()}

"""Layer stacks: port of ``repro/models/transformer.py`` for the dense block.

The reference scans a stacked ``[L, ...]`` parameter pytree with optional
remat; the port keeps one parameter dict a layer and loops over them in
Python.  ``cfg.remat`` wraps each block in
``torch.utils.checkpoint.checkpoint`` when gradients are on (the
reference's ``jax.checkpoint`` of the scan body): the backward keeps each
block's input and recomputes the rest.  The MoE, MLA, enc-dec and hybrid
blocks come with the other families (ROADMAP.md §1 item 2, slice 3).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import attention_block, init_attention
from repro_torch.models.layers import init_dense, rms_norm, swiglu


def init_block(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    """One dense block's parameters, the reference's dict: ln1, attn {wq,
    wk, wv, wo}, ln2, mlp {w1, w3, w2}; the norm scales start at zero."""
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln1": torch.zeros((d,), dtype=dtype, device=gen.device),
        "attn": init_attention(gen, cfg, dtype),
        "ln2": torch.zeros((d,), dtype=dtype, device=gen.device),
        "mlp": {
            "w1": init_dense(gen, (d, ff), dtype),
            "w3": init_dense(gen, (d, ff), dtype),
            "w2": init_dense(gen, (ff, d), dtype, scale=ff**-0.5 / (2 * cfg.n_layers) ** 0.5),
        },
    }


def block_forward(params, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, *,
                  cache=None, cache_pos=None) -> torch.Tensor:
    """One dense block: causal self-attention with RoPE, then SwiGLU."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    attn_out, _ = attention_block(params["attn"], h, positions, cfg,
                                  cache=cache, cache_pos=cache_pos)
    x = x + attn_out
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    return x + swiglu(h, **params["mlp"])


def init_stack(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> list[dict]:
    return [init_block(gen, cfg, dtype) for _ in range(cfg.n_layers)]


def stack_forward(params, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, *,
                  cache=None, cache_pos=None) -> torch.Tensor:
    """Loop over the block dicts.  ``cache`` is the stacked ``{k, v}`` of
    ``[L, B, S, Hkv, dh]`` tensors (layer i reads and writes its view
    ``cache["k"][i]`` in place), or None.  Each block is rematerialised
    in the backward when ``cfg.remat`` and gradients are on (serving runs
    under ``no_grad``, so never there)."""
    if cache is None and cfg.remat and torch.is_grad_enabled():
        for layer in params:
            x = checkpoint(block_forward, layer, x, positions, cfg, use_reentrant=False)
        return x
    for i, layer in enumerate(params):
        layer_cache = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i]}
        x = block_forward(layer, x, positions, cfg, cache=layer_cache, cache_pos=cache_pos)
    return x

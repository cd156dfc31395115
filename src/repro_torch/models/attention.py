"""GQA/MHA attention block with a KV cache, and the enc-dec
cross-attention: port of ``repro/models/attention.py``.

The decode path writes the cache **in place** and returns it (the
reference returns a new cache): a copy of a 30-layer cache every token
would move as many bytes as the attention reads.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import apply_rope, attention, chunked_attention, init_dense


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": init_dense(gen, (d, cfg.n_heads * hd), dtype),
        "wk": init_dense(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wv": init_dense(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wo": init_dense(gen, (cfg.n_heads * hd, d), dtype,
                         scale=(cfg.n_heads * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5),
    }


def init_kv_cache(cfg: ArchConfig, batch: int, seq: int, dtype: torch.dtype,
                  device=None) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, seq, cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, seq, cfg.n_kv_heads, hd), dtype=dtype, device=device),
    }


def attention_block(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ArchConfig,
    *,
    causal: bool = True,
    use_rope: bool = True,
    cache: dict | None = None,
    cache_pos: torch.Tensor | None = None,
    cross_kv=None,
):
    """Returns (out, cache).

    prefill: x [B, S, D], cache None -> chunked flash attention, causal
    and with RoPE unless told otherwise (whisper's encoder turns both off).
    decode: x [B, 1, D], cache {k, v} of capacity S; slot b writes its row
    at ``min(cache_pos[b], S - 1)`` and attends over the whole capacity
    with the mask ``kpos <= pos`` (a refilled slot's old rows stay, hidden).
    cross_kv: the encoder's (k, v) [B, F, Hkv, dh]: q from ``x``, the plain
    non-causal attention over all F frames; neither RoPE nor the cache is
    touched.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, hd)
    if cross_kv is not None:
        k, v = cross_kv
        out = attention(q, k, v, causal=False)
        return out.reshape(b, s, -1) @ params["wo"], cache

    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    else:
        k_cache, v_cache = cache["k"], cache["v"]
        cap = k_cache.shape[1]
        pos = torch.clamp(cache_pos, max=cap - 1)                 # [B]
        # dynamic_update_slice's rows: the start clamped so all s rows fit
        rows = torch.clamp(pos, max=cap - s)[:, None] + torch.arange(s, device=x.device)
        slots = torch.arange(b, device=x.device)[:, None]
        k_cache[slots, rows] = k.to(k_cache.dtype)
        v_cache[slots, rows] = v.to(v_cache.dtype)
        kpos = torch.arange(cap, device=x.device)[None, :]
        mask = (kpos <= pos[:, None])[:, None, None, :]          # [B, 1, 1, cap]
        out = attention(q, k_cache, v_cache, causal=False, mask=mask)
    return out.reshape(b, s, -1) @ params["wo"], cache

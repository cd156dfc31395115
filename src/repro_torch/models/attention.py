"""GQA/MHA attention block with a KV cache, and the enc-dec
cross-attention: port of ``repro/models/attention.py``.

The decode path writes the cache **in place** and returns it (the
reference returns a new cache): a copy of a 30-layer cache every token
would move as many bytes as the attention reads.

Under an active mesh whose model axis M divides the query heads, the
cache-free path (training, prefill, the cross-attention) is
tensor-parallel as the reference's parameter rules shard it: model shard
m holds the column blocks of ``wq``, ``wk`` and ``wv`` and the row block
of ``wo`` for its H / M heads, attends over them on its device, and one
psum follows ``wo``.  Where M does not divide the KV heads, K and V are
computed whole (``wk``, ``wv`` replicated) and each shard takes the KV
heads that its query heads read.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import broadcast, reduce_sum
from repro_torch.distributed.sharding import shard_group
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
    group = shard_group("heads", cfg.n_heads) if cache is None else None
    if group is not None:
        return _attention_tp(params, x, positions, cfg, group, causal=causal,
                             use_rope=use_rope, cross_kv=cross_kv), cache
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


def _attention_tp(params, x, positions, cfg: ArchConfig, group, *, causal: bool,
                  use_rope: bool, cross_kv):
    """The cache-free attention block split by heads over ``group`` (the
    model axis of the current data shard): shard m's partial output
    ``attn_m @ wo[rows_m]`` on its device, summed in rank order onto x's."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    m_size = group.size
    h_loc = cfg.n_heads // m_size
    n_rep = cfg.n_heads // cfg.n_kv_heads
    split_kv = cross_kv is None and cfg.n_kv_heads % m_size == 0
    if cross_kv is not None:
        k_all, v_all = cross_kv
    elif not split_kv:
        # K and V replicated: computed whole on x's device, selected by head
        k_all = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
        v_all = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
        if use_rope:
            k_all = apply_rope(k_all, positions, cfg.rope_theta)
    cols = h_loc * hd
    wq, wo = params["wq"].split(cols, dim=-1), params["wo"].split(cols, dim=0)
    if split_kv:
        kv_cols = cfg.n_kv_heads // m_size * hd
        wk, wv = params["wk"].split(kv_cols, dim=-1), params["wv"].split(kv_cols, dim=-1)
    parts = []
    for m, (dev, xm) in enumerate(zip(group.devices, broadcast(group, x))):
        q = (xm @ wq[m].to(dev, non_blocking=True)).reshape(b, s, h_loc, hd)
        if split_kv:
            k = (xm @ wk[m].to(dev, non_blocking=True)).reshape(b, s, -1, hd)
            v = (xm @ wv[m].to(dev, non_blocking=True)).reshape(b, s, -1, hd)
        else:
            # the KV head each of this shard's query heads reads (j // n_rep)
            heads = torch.arange(m * h_loc, (m + 1) * h_loc, device=x.device) // n_rep
            k = k_all[:, :, heads].to(dev, non_blocking=True)
            v = v_all[:, :, heads].to(dev, non_blocking=True)
        if cross_kv is not None:
            out = attention(q, k, v, causal=False)
        else:
            pos = positions.to(dev, non_blocking=True)
            if use_rope:
                q = apply_rope(q, pos, cfg.rope_theta)
                if split_kv:
                    k = apply_rope(k, pos, cfg.rope_theta)
            out = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
        parts.append(out.reshape(b, s, -1) @ wo[m].to(dev, non_blocking=True))
    return reduce_sum(parts, x.device)

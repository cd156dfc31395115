"""Multi-head Latent Attention (DeepSeek V2/V3): port of
``repro/models/mla.py``.

Train and prefill materialise per-head K/V from the latent and run the
chunked flash attention.  Decode uses the *absorbed* formulation: W_uk is
folded into the query and W_uv into the output, so attention runs directly
against the cached latent ``ckv [B, S, r]`` and the shared ``krope
[B, S, dr]`` (r + dr = 576 values a token at full width, instead of
2 x H x dh).  As the dense cache does (``models/attention.py``), the
decode path writes the latent cache **in place** and returns it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import apply_rope, chunked_attention, init_dense, rms_norm


def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    """The reference's MLA parameters; ``w_dq`` and ``q_ln`` only with a
    ``q_lora_rank``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qin = m.q_lora_rank or d
    p = {
        "w_dkv": init_dense(gen, (d, m.kv_lora_rank), dtype),
        "kv_ln": torch.zeros((m.kv_lora_rank,), dtype=dtype, device=gen.device),
        "w_krope": init_dense(gen, (d, m.qk_rope_head_dim), dtype),
        "w_uk": init_dense(gen, (m.kv_lora_rank, h * m.qk_nope_head_dim), dtype),
        "w_uv": init_dense(gen, (m.kv_lora_rank, h * m.v_head_dim), dtype),
        "w_uq": init_dense(gen, (qin, h * (m.qk_nope_head_dim + m.qk_rope_head_dim)), dtype),
        "wo": init_dense(gen, (h * m.v_head_dim, d), dtype,
                         scale=(h * m.v_head_dim) ** -0.5 / (2 * cfg.n_layers) ** 0.5),
    }
    if m.q_lora_rank:
        p["w_dq"] = init_dense(gen, (d, m.q_lora_rank), dtype)
        p["q_ln"] = torch.zeros((m.q_lora_rank,), dtype=dtype, device=gen.device)
    return p


def init_mla_cache(cfg: ArchConfig, batch: int, seq: int, dtype: torch.dtype,
                   device=None) -> dict:
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, seq, m.kv_lora_rank), dtype=dtype, device=device),
        "krope": torch.zeros((batch, seq, m.qk_rope_head_dim), dtype=dtype, device=device),
    }


def _queries(params, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    m = cfg.mla
    b, s, _ = x.shape
    if m.q_lora_rank:
        cq = rms_norm(x @ params["w_dq"], params["q_ln"], cfg.norm_eps)
    else:
        cq = x
    q = (cq @ params["w_uq"]).reshape(b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_block(params, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, *,
              cache: dict | None = None, cache_pos: torch.Tensor | None = None):
    """Returns (out, cache).

    train / prefill: x [B, S, D], cache None -> per-head K and V from the
    latent (the shared rope key broadcast over the heads, V zero-padded to
    the QK head dim so that ``chunked_attention`` sees uniform shapes, the
    output cut back to ``v_head_dim``).
    decode: cache ``{ckv, krope}`` of capacity S; slot b writes its row at
    ``min(cache_pos[b], S - 1)``, then the absorbed attention over the
    whole capacity in float32 with the mask ``t <= pos``; the context is
    cast back to the compute dtype before ``W_uv``.
    """
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _queries(params, x, positions, cfg)
    ckv = rms_norm(x @ params["w_dkv"], params["kv_ln"], cfg.norm_eps)       # [B, S, r]
    krope = apply_rope((x @ params["w_krope"])[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0, :]                           # [B, S, dr]

    if cache is None:
        k_nope = (ckv @ params["w_uk"]).reshape(b, s, h, m.qk_nope_head_dim)
        v = (ckv @ params["w_uv"]).reshape(b, s, h, m.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, krope[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)], dim=-1)
        out = chunked_attention(q, k, F.pad(v, (0, q.shape[-1] - v.shape[-1])),
                                causal=cfg.causal, chunk=cfg.attn_chunk)
        out = out[..., : m.v_head_dim]
    else:
        ckv_c, kr_c = cache["ckv"], cache["krope"]
        cap = ckv_c.shape[1]
        pos = torch.clamp(cache_pos, max=cap - 1)                             # [B]
        # dynamic_update_slice's rows: the start clamped so all s rows fit
        rows = torch.clamp(pos, max=cap - s)[:, None] + torch.arange(s, device=x.device)
        slots = torch.arange(b, device=x.device)[:, None]
        ckv_c[slots, rows] = ckv.to(ckv_c.dtype)
        kr_c[slots, rows] = krope.to(kr_c.dtype)
        w_uk = params["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)                  # absorb W_uk
        scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
        ckv32 = ckv_c.float()
        logits = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv32)
                  + torch.einsum("bshe,bte->bhst", q_rope.float(), kr_c.float())) * scale
        mask = (torch.arange(cap, device=x.device)[None, :] <= pos[:, None])[:, None, None, :]
        probs = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
        ctx_lat = torch.einsum("bhst,btr->bshr", probs, ckv32).to(x.dtype)
        w_uv = params["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
        out = torch.einsum("bshr,rhv->bshv", ctx_lat, w_uv)                   # absorb W_uv
    return out.reshape(b, s, -1) @ params["wo"], cache

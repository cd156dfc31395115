"""Architecture + parallelism configuration schema: port of
``repro/configs/base.py``.

One ``ArchConfig`` instance per assigned architecture (see the sibling
modules); ``reduced()`` derives the CPU smoke-test configuration of the same
family.  Shapes are the assigned (seq_len, global_batch) cells.  The port
keeps its own copy (the reference's imports ``jax.numpy`` for its dtypes):
the dataclasses and ``param_count`` are the reference's, and ``pdtype()`` /
``cdtype()`` return ``torch.dtype`` values.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    top_k: int = 6
    n_shared: int = 2
    expert_d_ff: int = 1408
    shared_d_ff: int | None = None          # default: n_shared * expert_d_ff
    first_dense_layers: int = 1
    dense_d_ff: int = 10944                 # d_ff of the leading dense layers
    router: Literal["softmax", "sigmoid_bias"] = "softmax"
    norm_topk_prob: bool = False
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int | None = None          # None = full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64                     # N
    head_dim: int = 64                      # P
    expand: int = 2                         # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128                        # SSD chunk length
    # hybrid (zamba2-style): one *shared* attention block applied every
    # `shared_stride` SSM layers (0 = pure SSM)
    shared_stride: int = 0
    shared_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    # "scan" = faithful per-step recurrence; "chunked" = parallel chunked
    # WKV (one state touch per chunk — §Perf hillclimb, default for train)
    wkv_mode: str = "chunked"


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 4
    n_frames: int = 1500                    # stubbed audio frontend length


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 2880                   # anyres tiling stub (5 tiles x 576)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None             # None = d_model // n_heads
    attention: Literal["gqa", "mla", "none"] = "gqa"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    causal: bool = True
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    enc_dec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    mtp: bool = False                       # DeepSeek-V3 multi-token prediction
    mtp_loss_weight: float = 0.3
    # numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"        # "bfloat16" = compressed moments
    optimizer_factored: bool = False        # Adafactor-style factored 2nd moment
    grad_accum: int = 1                     # microbatch accumulation steps
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 512                   # kv-chunked attention block
    # which assigned shapes are skipped and why (DESIGN.md §Arch-applicability)
    skip_shapes: tuple[str, ...] = ()
    skip_reason: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def pdtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return _torch_dtype(self.compute_dtype)


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def param_count(cfg: ArchConfig) -> tuple[int, int]:
    """(total, active-per-token) parameter counts — used for MODEL_FLOPS."""
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.resolved_head_dim
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)

    def attn_params():
        if cfg.attention == "mla":
            m = cfg.mla
            qin = m.q_lora_rank or d
            p = d * (m.kv_lora_rank + m.qk_rope_head_dim)          # down kv + rope
            p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            if m.q_lora_rank:
                p += d * m.q_lora_rank
            p += qin * cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            p += cfg.n_heads * m.v_head_dim * d                    # o proj
            return p
        if cfg.attention == "none":
            return 0
        return d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d

    def ffn_params(ff):
        return 3 * d * ff                                          # SwiGLU

    total = emb
    active = emb
    if cfg.family == "ssm":
        if cfg.rwkv is not None:
            per_layer = 4 * d * d + 3 * d * d + int(2.1 * d * cfg.d_ff)  # wkv + ffn approx
        else:
            per_layer = 2 * d * (cfg.ssm.expand * d) + d * cfg.d_ff * 3
        total += L * per_layer
        active += L * per_layer
        return int(total), int(active)
    if cfg.family == "hybrid":
        s = cfg.ssm
        din = s.expand * d
        mamba = L * (2 * d * din + din * d + din * (2 * s.state_dim))
        n_shared_apps = L // max(s.shared_stride, 1) if s.shared_stride else 0
        shared = (d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
                  + ffn_params(s.shared_d_ff)) if n_shared_apps else 0
        total += mamba + shared
        active += mamba + shared * n_shared_apps  # shared weights reused
        return int(total), int(active)

    per_layer_attn = attn_params()
    if cfg.moe is not None:
        m = cfg.moe
        n_dense = m.first_dense_layers
        n_moe = L - n_dense
        shared_ff = m.shared_d_ff or m.n_shared * m.expert_d_ff
        dense_p = n_dense * (per_layer_attn + ffn_params(m.dense_d_ff))
        moe_total = n_moe * (per_layer_attn + ffn_params(shared_ff)
                             + m.n_experts * ffn_params(m.expert_d_ff) + d * m.n_experts)
        moe_active = n_moe * (per_layer_attn + ffn_params(shared_ff)
                              + m.top_k * ffn_params(m.expert_d_ff) + d * m.n_experts)
        total += dense_p + moe_total
        active += dense_p + moe_active
    else:
        if cfg.enc_dec is not None:
            enc = cfg.enc_dec.n_encoder_layers * (per_layer_attn + ffn_params(cfg.d_ff))
            dec = L * (2 * per_layer_attn + ffn_params(cfg.d_ff))  # self + cross
            total += enc + dec
            active += enc + dec
        else:
            total += L * (per_layer_attn + ffn_params(cfg.d_ff))
            active += L * (per_layer_attn + ffn_params(cfg.d_ff))
    return int(total), int(active)

"""llama3-405b [arXiv:2407.21783]: dense GQA at maximum assigned scale.

126L, d_model=16384, 128 heads (GQA kv=8), d_ff=53248, vocab=128256,
rope theta 500k.  bf16 optimizer moments (memory compression) so the
train_4k cell fits the 256-chip v5e pod.  long_500k skipped (full attn).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3_405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    param_dtype="bfloat16",       # + bf16 m + factored v: ~4.5 B/param state
    optimizer_dtype="bfloat16",
    optimizer_factored=True,
    grad_accum=16,                # 1M-token batch in 16 microbatches
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention decoder; 500k decode needs sub-quadratic attention",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512, param_dtype="float32", optimizer_dtype="float32",
    )

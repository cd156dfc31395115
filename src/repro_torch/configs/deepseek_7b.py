"""deepseek-7b [arXiv:2401.02954]: llama-architecture dense MHA.

30L, d_model=4096, 32 heads (kv=32 -> MHA), d_ff=11008, vocab=102400.
long_500k skipped (full attention).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    head_dim=128,
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention decoder; 500k decode needs sub-quadratic attention",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=192, vocab_size=512,
    )

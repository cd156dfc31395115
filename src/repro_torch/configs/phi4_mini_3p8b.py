"""phi4-mini-3.8b [arXiv:2412.08905]: dense GQA, huge vocab.

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=200064.
long_500k skipped (full attention).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4_mini_3p8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    head_dim=128,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention decoder; 500k decode needs sub-quadratic attention",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=512,
    )

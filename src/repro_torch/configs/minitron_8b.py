"""minitron-8b [arXiv:2407.14679]: width-pruned Nemotron-4, dense GQA.

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=16384, vocab=256000.
long_500k skipped (full attention).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron_8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention decoder; 500k decode needs sub-quadratic attention",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512,
    )

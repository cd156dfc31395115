"""zamba2-2.7b [arXiv:2411.15242]: Mamba2 backbone + shared attention block.

54 Mamba2 layers, d_model=2560, ssm_state=64; one *shared* attention+MLP
block (32 heads, d_ff=10240) applied every 6 layers (weights reused — the
Zamba trick).  Sub-quadratic: runs long_500k (shared-block KV caches are
sequence-sharded over the data axis for decode).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2_2p7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk=128, shared_stride=6, shared_d_ff=10240),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=512,
        ssm=SSMConfig(state_dim=8, head_dim=16, expand=2, conv_width=4,
                      chunk=16, shared_stride=2, shared_d_ff=128),
    )

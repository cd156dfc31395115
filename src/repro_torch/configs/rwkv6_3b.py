"""rwkv6-3b "Finch" [arXiv:2404.05892]: attention-free, data-dependent decay.

32L, d_model=2560, d_ff=8960, vocab=65536, head_dim=64 (40 heads).
Runs long_500k: decode is O(1)-state recurrence, no KV cache at all.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6_3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    attention="none",
    rwkv=RWKVConfig(head_dim=64, wkv_mode="chunked"),
    # §Perf note: grad_accum=8 was tried and REFUTED — accumulation splits
    # peak memory, not traffic, and re-gathers params per microbatch
    # (262s -> 424s memory term); see EXPERIMENTS.md §Perf.
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, rwkv=RWKVConfig(head_dim=16),
    )

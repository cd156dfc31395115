"""deepseek-v2-lite-16b [arXiv:2405.04434]: MLA + fine-grained MoE.

27L, d_model=2048, 16 heads, vocab=102400; MLA kv_lora=512 (rope 64/nope 128,
v 128); MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408, first
layer dense (d_ff=10944).  NOTE: the assignment line lists both "64e top-6"
and "160 routed"; the published v2-lite config is 64 routed experts — we
follow the published card and the "64e top-6" reading.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek_v2_lite_16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, expert_d_ff=1408,
                  first_dense_layers=1, dense_d_ff=10944, router="softmax"),
    skip_shapes=("long_500k",),
    skip_reason="full (latent) attention over the sequence; 500k decode skipped",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, d_ff=96,
        vocab_size=512,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=None,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=2, expert_d_ff=32,
                      first_dense_layers=1, dense_d_ff=96, router="softmax"),
    )

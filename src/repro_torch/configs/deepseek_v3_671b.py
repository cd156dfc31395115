"""deepseek-v3-671b [arXiv:2412.19437]: MLA + 256-expert MoE + MTP.

61L, d_model=7168, 128 heads, vocab=129280; MLA kv_lora=512, q_lora=1536;
MoE: 256 routed top-8 (sigmoid router with aux-free bias, normalized top-k
probs) + 1 shared, expert d_ff=2048, first 3 layers dense (d_ff=18432);
multi-token prediction (depth-1 MTP module).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek_v3_671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, expert_d_ff=2048,
                  first_dense_layers=3, dense_d_ff=18432,
                  router="sigmoid_bias", norm_topk_prob=True),
    mtp=True,
    param_dtype="bfloat16",
    optimizer_dtype="bfloat16",   # moment compression for the 671B cell
    optimizer_factored=True,
    grad_accum=8,
    skip_shapes=("long_500k",),
    skip_reason="full (latent) attention over the sequence; 500k decode skipped",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, d_ff=96,
        vocab_size=512, mtp=True,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, expert_d_ff=32,
                      first_dense_layers=1, dense_d_ff=96,
                      router="sigmoid_bias", norm_topk_prob=True),
    )

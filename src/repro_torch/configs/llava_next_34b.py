"""llava-next-34b [hf:llava-hf/llava-v1.6]: VLM — dense decoder backbone.

60L, d_model=7168, 56 heads (GQA kv=8), d_ff=20480, vocab=64000 (Yi-34B-class
backbone).  The anyres vision tower is a STUB per assignment: input_specs
provide pre-projected patch embeddings [B, 2880, d_model] prepended to the
text sequence; loss masks patch positions.  long_500k skipped (full attn).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="llava_next_34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5000000.0,
    vlm=VLMConfig(n_patches=2880),
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention decoder; 500k decode needs sub-quadratic attention",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, vlm=VLMConfig(n_patches=8),
    )

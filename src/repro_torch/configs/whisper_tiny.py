"""whisper-tiny [arXiv:2212.04356]: enc-dec audio transformer.

4L decoder (+4L encoder), d_model=384, 6 heads (kv=6 -> MHA), d_ff=1536,
vocab=51865.  Conv frontend is a STUB per assignment: input_specs provide
precomputed frame embeddings [B, 1500, 384].  long_500k skipped (pure full
attention, DESIGN.md §Arch-applicability).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper_tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    attention="gqa",
    tie_embeddings=True,   # whisper ties the decoder embedding
    enc_dec=EncDecConfig(n_encoder_layers=4, n_frames=1500),
    causal=True,
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention enc-dec; 500k decode needs sub-quadratic attention",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=512,
        enc_dec=EncDecConfig(n_encoder_layers=2, n_frames=16),
    )

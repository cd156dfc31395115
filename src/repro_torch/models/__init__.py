"""The LM substrate's models on the port (port of ``repro/models``): the dense
and MoE decoders' layers, attention with a KV cache, Multi-head Latent
Attention with its latent cache, the MoE block, the layer stack and
``build_model``."""

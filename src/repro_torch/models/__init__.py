"""The LM substrate's models on the port (port of ``repro/models``): the dense
decoder's layers, attention with a KV cache, the layer stack and
``build_model``."""

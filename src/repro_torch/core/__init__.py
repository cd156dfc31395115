"""Core Barnes-Hut t-SNE library, PyTorch port of ``repro.core``."""

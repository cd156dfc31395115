"""Hand-written CUDA kernels for Hopper and their registry (``ops``)."""

"""Hand-written CUDA kernels and their wrappers."""

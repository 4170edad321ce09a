"""Hand-written CUDA kernels for Hopper, their build and their wrappers."""

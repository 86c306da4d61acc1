"""The hand-written CUDA kernels (csrc/) and their wrappers."""

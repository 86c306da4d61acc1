"""Lane-major rigid-body and SQP building blocks, and the CUDA kernels."""

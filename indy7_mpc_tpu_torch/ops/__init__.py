"""Lane-major rigid-body and SQP building blocks, the readable QP
backends, and the CUDA kernels."""
from . import kkt, pcg, riccati, riccati_pscan

__all__ = ["kkt", "pcg", "riccati", "riccati_pscan"]

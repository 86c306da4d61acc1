"""indy7_mpc_tpu_torch: the PyTorch/CUDA port of indy7_mpc_tpu.

The sampled-MPC closed loop (batched SQP solves under wrench hypotheses,
consensus, ground-truth plant) on PyTorch tensors, with the two hot
kernels hand-written in CUDA C++ for Hopper (``csrc/``):

  * ``ops/kernels/sqp_kernel.py`` — the batched SQP solve (K1);
  * ``ops/kernels/tick_kernel.py`` — consensus, argmin, plant and FK (K2).

Each kernel wrapper runs its plain PyTorch version for CPU tensors and
launches the CUDA kernel for CUDA tensors.  The configuration dataclasses
(``config.py``) have the TPU package's fields and defaults, and the port
reads them by attribute, so the TPU package's config objects drive it
too.  This package never imports JAX or the TPU package.
"""

__version__ = "0.1.0"

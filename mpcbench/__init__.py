"""The benchmark of ``indy7_mpc_tpu_torch``, the PyTorch and CUDA port of
sampled MPC for the Indy7, on one NVIDIA H100 (``run.py``)."""

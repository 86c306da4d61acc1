"""indy7_mpc_tpu_torch: the PyTorch/CUDA port of indy7_mpc_tpu.

On PyTorch tensors: the sampled-MPC closed loop (batched SQP solves under
wrench hypotheses, consensus, ground-truth plant; ``mpc.run_sampled_mpc``),
the host-driven runtime around its controller tick (``runtime``:
``SampledController`` over a UDP link to the native C++ plant, ``sim/native``,
or against an in-process plant, with stats recording and checkpoints),
and the single-lane loops ``mpc.run_mpc`` and ``mpc.run_tracking_mpc``.
The two hot kernels are hand-written in CUDA C++ for Hopper (``csrc/``):

  * ``ops/kernels/sqp_kernel.py`` — the batched SQP solve (K1);
  * ``ops/kernels/tick_kernel.py`` — consensus, argmin, plant and FK (K2).

Each kernel wrapper runs its plain PyTorch version for CPU tensors and
launches the CUDA kernel for CUDA tensors.  Beside them sits the readable
layer: the spatial algebra and rigid-body dynamics on ``RobotModel``s
(``models/spatial.py``, ``dynamics/``), the URDF and MJCF parsers
(``models/urdf.py``, ``models/mjcf.py``, on the package's own copies of
the description files), the QP blocks with autodiff linearization and
both cost formulations (``ops/kkt.py``), the Riccati sweep and a dense KKT
oracle (``ops/riccati.py``, ``ops/dense_kkt.py``), the vmap-style batched
SQP solver (``solvers/sqp.py``) and the readable tick
(``mpc/readable_tick.py``, ``fused=False``).  It is the kernels' oracle
and the path of every configuration outside K1's coverage.  The configuration dataclasses
(``config.py``) have the TPU package's fields and defaults, and the port
reads them by attribute, so the TPU package's config objects drive it
too.  This package never imports JAX or the TPU package.
"""

__version__ = "0.1.0"

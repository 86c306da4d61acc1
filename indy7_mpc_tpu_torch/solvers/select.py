"""Production solver selection (port of ``solvers/select.py``).

The port has one solver, kernel K1 behind ``sqp_cuda.batch_solve`` and
``sqp_cuda.single_solve_fn``: its wrapper launches the kernel for CUDA
tensors and runs the plain version for CPU tensors.  Both cover the
Gauss-Newton formulation with the Riccati backend only; the port has no
vmap solver to fall back to, so any other configuration raises.
"""
from __future__ import annotations

from ..config import CostConfig, SQPConfig
from ..models.robot import RobotModel
from ..ops.kernels.sqp_kernel import require_kernel_config


def default_batch_solve_fn(
    model: RobotModel, cost_cfg: CostConfig, sqp_cfg: SQPConfig, dt: float
):
    """``(xs_b, goals_b, X_b, U_b, wrench_b) -> SQPResult`` on the kernel
    for CUDA tensors and on its plain version for CPU tensors."""
    require_kernel_config(cost_cfg, sqp_cfg)
    from . import sqp_cuda

    return lambda xs, g, X, U, w: sqp_cuda.batch_solve(
        model, cost_cfg, sqp_cfg, dt, xs, g, X, U, wrench_world_batch=w
    )


def default_single_solve_fn(
    model: RobotModel, cost_cfg: CostConfig, sqp_cfg: SQPConfig, dt: float
):
    """Single-lane ``(xs, goals, X, U, state=None, wrench_world=None) ->
    SQPResult`` (for run_mpc and run_tracking_mpc): the kernel at B = 1 for
    CUDA tensors, its plain version for CPU tensors."""
    require_kernel_config(cost_cfg, sqp_cfg)
    from . import sqp_cuda

    return sqp_cuda.single_solve_fn(model, cost_cfg, sqp_cfg, dt)

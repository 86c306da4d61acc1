"""Production solver selection (port of ``solvers/select.py``).

Kernel K1 covers the Gauss-Newton formulation with the Riccati backend:
inside that coverage the default solvers are ``sqp_cuda.batch_solve_fn`` and
``sqp_cuda.single_solve_fn``, whose wrapper launches the kernel for CUDA
tensors and runs its plain version for CPU tensors.  Every other
configuration (``formulation="reference"``, or the QP backends "pcg",
"admm" and "riccati_pscan") falls back to the readable solver
(``solvers/sqp.py``) on any device, with a warning when the target device
is a card.  An unknown QP backend raises ``ValueError``.

Every consumer of a batched solve (``mpc.sampled.sampled_tick``,
``make_loop_tick``, the runtime controller) resolves its default through
:func:`default_batch_solve_fn`.
"""
from __future__ import annotations

import logging

import torch

from ..config import CostConfig, SQPConfig
from ..models.robot import RobotModel
from .sqp import require_qp_backend

logger = logging.getLogger(__name__)


def _warn_slow_path_on_cuda(cost_cfg: CostConfig, sqp_cfg: SQPConfig) -> None:
    """A card fell back to the readable solver (many small launches a
    solve, far slower than K1) because the config is outside the kernel's
    coverage: loud, so nobody ships the slow path by accident."""
    logger.warning(
        "CUDA device but config (formulation=%r, qp_backend=%r) is outside "
        "the SQP kernel's coverage (gn + riccati); falling back to the "
        "readable solver (many small launches a solve, far slower than K1).",
        cost_cfg.formulation, sqp_cfg.qp_backend,
    )


def is_cuda_device(device=None) -> bool:
    """True when ``device`` is a CUDA device; ``None`` names the port's
    default device, the card when there is one."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def kernel_supports(cost_cfg: CostConfig, sqp_cfg: SQPConfig) -> bool:
    """K1 implements the GN formulation with the direct Riccati backend
    only; other configs fall back to the readable solver."""
    return cost_cfg.formulation == "gn" and sqp_cfg.qp_backend == "riccati"


def default_batch_solve_fn(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    device=None,
):
    """``(xs_b, goals_b, X_b, U_b, wrench_b) -> SQPResult``: K1 (or its
    plain version for CPU tensors) inside its coverage, else the readable
    solver; ``device`` is the target device, for the warning."""
    require_qp_backend(sqp_cfg)
    if kernel_supports(cost_cfg, sqp_cfg):
        from . import sqp_cuda

        return sqp_cuda.batch_solve_fn(model, cost_cfg, sqp_cfg, dt)
    if is_cuda_device(device):
        _warn_slow_path_on_cuda(cost_cfg, sqp_cfg)
    from . import sqp as sqp_mod

    return sqp_mod.batch_solve_fn(model, cost_cfg, sqp_cfg, dt)


def default_single_solve_fn(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    device=None,
):
    """Single-lane ``(xs, goals, X, U, state=None, wrench_world=None) ->
    SQPResult`` (for run_mpc and run_tracking_mpc): K1 at B = 1 for CUDA
    tensors and its plain version for CPU tensors inside its coverage,
    else the readable solver."""
    require_qp_backend(sqp_cfg)
    if kernel_supports(cost_cfg, sqp_cfg):
        from . import sqp_cuda

        return sqp_cuda.single_solve_fn(model, cost_cfg, sqp_cfg, dt)
    if is_cuda_device(device):
        _warn_slow_path_on_cuda(cost_cfg, sqp_cfg)
    from . import sqp as sqp_mod

    return lambda xs, goals, X, U, state=None, wrench_world=None: sqp_mod.solve(
        model, cost_cfg, sqp_cfg, dt, xs, goals, X, U, state=state,
        wrench_world=wrench_world,
    )

"""B-major SQP solves on kernel K1 (port of ``solvers/sqp_pallas.py``).

Same array contracts as the TPU package's ``sqp_pallas.batch_solve`` and
``single_solve_fn``.  On CUDA the kernel runs in float32; on the CPU the
wrapper's plain version runs in the inputs' dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import CostConfig, SQPConfig
from ..models.robot import RobotModel
from ..ops import lane_rbd as LR
from ..ops.kernels.sqp_kernel import sqp_solve
from .sqp import SolverState, SQPResult, SQPStats


def batch_solve(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    xs_b,
    goals_b,
    X_b,
    U_b,
    state: Optional[SolverState] = None,
    wrench_world_batch=None,
) -> SQPResult:
    """Lane-batched SQP solve on the SQP kernel.

    xs_b: (B, 12), goals_b: (B, N, 3), X_b: (B, N, 12), U_b: (B, N-1, 6),
    wrench_world_batch: (B, 6) or None.

    ``stats.iterations`` counts ACCEPTED steps (alpha > 0), as the TPU
    package's ``sqp_pallas.batch_solve`` does: a rejected iteration and an
    iteration after the step-norm exit both log alpha = 0 and are not
    told apart.
    """
    dtype = _kernel_dtype(X_b)
    sm = LR.static_model(model.to(dtype=dtype))
    return _solve(sm, cost_cfg, sqp_cfg, dt, xs_b, goals_b, X_b, U_b, state,
                  wrench_world_batch)


def _static_models(model: RobotModel):
    """``sm(X)``: the model constants for ``X``'s device and kernel dtype,
    built once each (building them reads the model to the host)."""
    static = {}

    def sm(X):
        key = (X.device, _kernel_dtype(X))
        if key not in static:
            static[key] = LR.static_model(model.to(device=key[0], dtype=key[1]))
        return static[key]

    return sm


def batch_solve_fn(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
):
    """``(xs_b, goals_b, X_b, U_b, wrench_b) -> SQPResult``: :func:`batch_solve`
    with the model constants built once per device and dtype, the signature
    every tick takes its batched solver in."""
    sm = _static_models(model)
    return lambda xs, g, X, U, w: _solve(sm(X), cost_cfg, sqp_cfg, dt, xs, g, X, U, None, w)


def single_solve_fn(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
):
    """Single-lane ``(xs, goals, X, U, state=None, wrench_world=None) ->
    SQPResult`` on the SQP kernel at B = 1, for ``run_mpc`` and
    ``run_tracking_mpc``.  xs (12,), goals (N, 3), X (N, 12), U (N-1, 6),
    wrench_world (6,) or None; ``state.rho`` is a 0-d tensor, carried in
    and out.  The model constants are built once per device and dtype."""
    sm = _static_models(model)

    def fn(xs, goals, X, U, state=None, wrench_world=None):
        res = _solve(
            sm(X), cost_cfg, sqp_cfg, dt, xs[None], goals[None], X[None],
            U[None], None if state is None else SolverState(rho=state.rho.reshape(1)),
            None if wrench_world is None else wrench_world[None],
        )
        # rho keeps the carried state's dtype (float32 from
        # SolverState.init), as the TPU package's solvers keep it.
        rho_dtype = torch.float32 if state is None else state.rho.dtype
        return SQPResult(
            X=res.X[0],
            U=res.U[0],
            state=SolverState(rho=res.state.rho[0].to(rho_dtype)),
            stats=SQPStats(*(None if a is None else a[0] for a in res.stats)),
        )

    return fn


def _kernel_dtype(t):
    return torch.float32 if t.device.type == "cuda" else t.dtype


def _solve(sm, cost_cfg, sqp_cfg, dt, xs_b, goals_b, X_b, U_b, state,
           wrench_world_batch) -> SQPResult:
    dtype = sm.mass.dtype

    def lane_major(t, perm):
        return t.to(dtype).permute(*perm).contiguous()

    rho = None if state is None else state.rho.to(dtype).contiguous()
    X, U, rho, alphas, steps = sqp_solve(
        sm, cost_cfg, sqp_cfg, dt,
        lane_major(xs_b, (1, 0)), lane_major(goals_b, (1, 2, 0)),
        lane_major(X_b, (1, 2, 0)), lane_major(U_b, (1, 2, 0)),
        wrench=None if wrench_world_batch is None
        else lane_major(wrench_world_batch, (1, 0)),
        rho=rho,
    )
    return SQPResult(
        X=X.permute(2, 0, 1),
        U=U.permute(2, 0, 1),
        state=SolverState(rho=rho),
        stats=SQPStats(
            iterations=(alphas > 0).sum(0).to(torch.int32),
            step_sizes=steps.T,
            alphas=alphas.T,
        ),
    )

"""Lane-major batched SQP solve: the plain PyTorch version of kernel K1.

Port of ``indy7_mpc_tpu/solvers/sqp_lane.py``, the readable twin of the
fused TPU kernel, on the shared engine (``ops/lane_rbd.py``,
``ops/lane_sqp.py``).  Same semantics as the CUDA kernel
(``csrc/sqp_kernel.cu``): a fixed iteration count with per-lane masked
updates, an 8-alpha merit line search where the largest accepted alpha
wins, the step-norm exit, and the per-lane Levenberg rho raised on
rejection.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import CostConfig, SQPConfig
from ..models.robot import RobotModel
from ..ops import lane_rbd as LR
from ..ops import lane_sqp as LS
from .sqp import SolverState, SQPResult, SQPStats


def solve_lane_major(
    sm: LR.StaticModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    xs,
    goals,
    X,
    U,
    wrench=None,
    rho=None,
):
    """The masked SQP iteration on lane-major tensors.

    xs (12, B), goals (N, 3, B), X (N, 12, B), U (N-1, 6, B), wrench
    (6, B) or None, rho (B,) or None.  Returns (X, U, rho (B,),
    alphas (iters, B), steps (iters, B), iterations (B,)), where
    ``iterations`` counts the iterations a lane ran before its step-norm
    exit (rejected ones included).
    """
    if cost_cfg.formulation != "gn":
        raise ValueError("lane solver implements the 'gn' formulation only")
    dtype, device = X.dtype, X.device
    B = xs.shape[-1]
    if rho is None:
        rho = SolverState.init(sqp_cfg, (B,), device).rho
    rho = rho.to(dtype)
    X = X.clone()
    X[0] = xs
    alphas = 0.5 ** torch.arange(sqp_cfg.num_alphas, dtype=dtype, device=device)
    alf = torch.cat([alphas, torch.zeros(1, dtype=dtype, device=device)])
    done = torch.zeros(B, dtype=torch.bool, device=device)
    iters = torch.zeros(B, dtype=torch.int32, device=device)
    step_log, alpha_log = [], []

    for _ in range(sqp_cfg.max_iters):
        blocks = LS.build_blocks(sm, cost_cfg, X, U, goals, dt, wrench=wrench)
        dX, dU = LS.riccati(blocks, torch.zeros_like(xs), rho)

        # Candidates: the alphas plus alpha=0 (the base merit).
        Xc = X[None] + alf[:, None, None, None] * dX[None]
        Uc = U[None] + alf[:, None, None, None] * dU[None]
        merits = LS.merit_batch(
            sm, cost_cfg, sqp_cfg.merit_mu, Xc, Uc, goals, X[0], dt,
            wrench=wrench,
        )
        ok = merits[:-1] <= merits[-1][None]
        any_ok = ok.any(0)
        first = ok.to(torch.int8).argmax(0)  # first True: the largest alpha
        alpha = torch.where(any_ok, alphas[first], 0.0)

        take = ~done & (alpha > 0.0)
        scale = torch.where(take, alpha, 0.0)
        X = X + scale * dX
        U = U + scale * dU
        step_norm = scale * torch.sqrt((dX * dX).sum((0, 1)) + (dU * dU).sum((0, 1)))
        step_log.append(step_norm)
        alpha_log.append(torch.where(done, 0.0, alpha))
        iters = iters + (~done).to(torch.int32)

        rejected = ~done & ~any_ok
        rho = torch.clamp(
            torch.where(rejected, rho * sqp_cfg.rho_factor, rho),
            sqp_cfg.rho, sqp_cfg.rho_max,
        )
        done = done | (take & (step_norm < sqp_cfg.step_tol))

    return X, U, rho, torch.stack(alpha_log), torch.stack(step_log), iters


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
    """Lane-batched SQP solve with the B-major API of ``sqp.batch_solve``.

    xs_b: (B, 12), goals_b: (B, N, 3), X_b: (B, N, 12), U_b: (B, N-1, 6),
    wrench_world_batch: (B, 6) or None.  ``stats.iterations`` counts the
    iterations each lane ran before its step-norm exit.
    """
    sm = LR.static_model(model.to(device=X_b.device, dtype=X_b.dtype))
    rho_dtype = torch.float32 if state is None else state.rho.dtype
    X, U, rho, alphas, steps, iters = solve_lane_major(
        sm, cost_cfg, sqp_cfg, dt,
        xs_b.T, goals_b.permute(1, 2, 0), X_b.permute(1, 2, 0),
        U_b.permute(1, 2, 0),
        wrench=None if wrench_world_batch is None else wrench_world_batch.T,
        rho=None if state is None else state.rho,
    )
    return SQPResult(
        X=X.permute(2, 0, 1),
        U=U.permute(2, 0, 1),
        state=SolverState(rho=rho.to(rho_dtype)),
        stats=SQPStats(iterations=iters, step_sizes=steps.T, alphas=alphas.T),
    )

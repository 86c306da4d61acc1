"""The readable batched SQP solver and the solver result types (port of
``indy7_mpc_tpu/solvers/sqp.py``).

The reference's SQP outer loop, on any lane count at once: linearize
(ops/kkt.py), solve the QP by the backend ``qp_backend`` names, merit
line search over ``num_alphas`` halving alphas (mu = 10), step-norm exit,
iteration cap, per-lane Levenberg rho raised on rejection.  Both cost
formulations ("gn" and "reference") and every QP backend: the Riccati
sweep (ops/riccati.py), its parallel-scan form (ops/riccati_pscan.py),
the dual PCG (ops/pcg.py) and ADMM (ops/admm.py).  It is the oracle of
kernel K1 (its derivatives come from autodiff, not from K1's ``Dual``
code) and the solver for every configuration outside K1's coverage.

Control flow is fixed-shape: a Python loop over ``max_iters`` with masked
per-lane updates; run eagerly, the PCG and ADMM loops read the host at
their exit checks (ops/while_loop.py), and under a CUDA graph capture
they run every iteration to their cap, masked, so a solve reads nothing
on the host and can be captured.  ``stats.iterations`` counts the
iterations a lane ran while not done, rejected ones included, as the TPU
package's readable solver does (K1 counts accepted steps).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import CostConfig, SQPConfig
from ..models.robot import RobotModel
from ..ops import admm, kkt, pcg, riccati, riccati_pscan


class SolverState(NamedTuple):
    """Per-lane solver state carried across solves: the Levenberg rho and,
    under ``qp_backend="admm"``, ADMM's primal iterate and constraint
    multipliers (OSQP's warm start, which the reference keeps by reusing
    one OSQP object across SQP iterations and ticks); ``None`` for the
    other backends."""

    rho: torch.Tensor  # (*b,)
    admm_z: Optional[torch.Tensor] = None  # (*b, N, nx+nu) primal iterate
    admm_y: Optional[torch.Tensor] = None  # (*b, N, nx) constraint duals

    @staticmethod
    def init(cfg: SQPConfig, batch_shape=(), device=None):
        # float32 like the TPU package, so both start from the same rho.
        return SolverState(
            rho=torch.full(batch_shape, cfg.rho, dtype=torch.float32, device=device)
        )


class SQPStats(NamedTuple):
    """Per-solve diagnostics (the reference's stats schema)."""

    iterations: torch.Tensor  # (*b,) iteration count; see each solver
    step_sizes: torch.Tensor  # (*b, max_iters) ||alpha * dz|| per iteration
    alphas: torch.Tensor      # (*b, max_iters) line-search alphas (0 = reject)
    # (*b, max_iters) int32 inner-QP iterations per SQP iteration under the
    # iterative backends, 0 once a lane is done: CG iterations under "pcg"
    # (the reference's pcg_stats[i].pcg_iterations), ADMM iterations under
    # "admm"; None under the direct backends.
    pcg_iters: Optional[torch.Tensor] = None


class SQPResult(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    state: SolverState
    stats: SQPStats


QP_BACKENDS = ("riccati", "riccati_pscan", "pcg", "admm")


def require_qp_backend(sqp_cfg: SQPConfig) -> None:
    """Raise ValueError for an unknown QP backend."""
    if sqp_cfg.qp_backend not in QP_BACKENDS:
        raise ValueError(f"unknown qp_backend {sqp_cfg.qp_backend!r}")


def merit(model, cost_cfg, mu, X, U, goals, x0_prev, dt, wrench_world=None):
    """Merit = nonlinear cost + mu * constraint violation (the reference's
    osqp_sqp.py), per lane: (*b,)."""
    qc, vc, uc = kkt.eepos_cost(model, cost_cfg, X, U, goals)
    cv = kkt.integrator_err(model, X, U, dt, wrench_world=wrench_world)
    cv = cv + torch.linalg.norm(X[..., 0, :] - x0_prev, dim=-1)
    return qc + vc + uc + mu * cv


def solve(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    xs,
    goals,
    X,
    U,
    state: Optional[SolverState] = None,
    wrench_world=None,
) -> SQPResult:
    """SQP solve of every lane at once, on the inputs' device and dtype.

    xs (*b, nx), goals (*b, N, 3), X (*b, N, nx), U (*b, N-1, nu),
    wrench_world (*b, 6) or None, ``state.rho`` (*b,); one lane is
    ``*b = ()``.  The model is moved to the inputs' device and dtype.
    Under ``qp_backend="admm"`` the returned state carries ADMM's iterate:
    pass it back to warm-start the next call, as the QPs of one call do.
    """
    require_qp_backend(sqp_cfg)
    batch, dtype, device = xs.shape[:-1], X.dtype, X.device
    model = model.to(device=device, dtype=dtype)
    if state is None:
        state = SolverState.init(sqp_cfg, batch, device)
    rho = state.rho.to(dtype)
    X = torch.cat([xs[..., None, :], X[..., 1:, :]], -2)  # pin the initial state

    # Exact powers of two (a CUDA pow of 0.5 can round 0.0625 down by an ulp),
    # built on the device: a host-to-device copy of a list would sync.
    alphas = torch.full((sqp_cfg.num_alphas,), 0.5, dtype=dtype, device=device).cumprod(0) * 2
    # Candidates: the alphas, then alpha = 0 (the base merit).
    cand = torch.cat([alphas, torch.zeros(1, dtype=dtype, device=device)])
    cand = cand.reshape((-1,) + (1,) * X.dim())
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    iters = torch.zeros(batch, dtype=torch.int32, device=device)
    step_log, alpha_log, qp_log = [], [], []
    gn = cost_cfg.formulation == "gn"
    # ADMM's warm start carries across SQP iterations and calls (OSQP's
    # object reuse); it is updated every iteration, done lanes included.
    admm_z, admm_y = state.admm_z, state.admm_y

    def qp_solve(blocks, x_init):
        nonlocal admm_z, admm_y
        if sqp_cfg.qp_backend == "pcg":
            sol = pcg.solve(blocks, x_init, rho, primal_reg=sqp_cfg.pcg_primal_reg,
                            tol=sqp_cfg.pcg_tol, max_iters=sqp_cfg.pcg_max_iters)
            return sol.X, sol.U, sol.iterations
        if sqp_cfg.qp_backend == "admm":
            sol = admm.solve(
                blocks, x_init, rho, sigma=sqp_cfg.admm_sigma, rho_admm=sqp_cfg.admm_rho,
                alpha=sqp_cfg.admm_alpha, eps_abs=sqp_cfg.admm_eps, eps_rel=sqp_cfg.admm_eps,
                max_iters=sqp_cfg.admm_max_iters, z0=admm_z, y0=admm_y,
            )
            admm_z, admm_y = sol.z, sol.y
            return sol.X, sol.U, sol.iterations
        if sqp_cfg.qp_backend == "riccati_pscan":
            sol = riccati_pscan.solve_pscan(blocks, x_init, rho)
        else:
            sol = riccati.solve(blocks, x_init, rho)
        return sol.X, sol.U, None

    for _ in range(sqp_cfg.max_iters):
        if gn:
            blocks = kkt.build_qp_gn(model, cost_cfg, X, U, goals, dt,
                                     wrench_world=wrench_world)
            dX, dU, qp_iters = qp_solve(blocks, xs - X[..., 0, :])
        else:
            blocks = kkt.build_qp(model, cost_cfg, X, U, goals, dt,
                                  wrench_world=wrench_world)
            Xq, Uq, qp_iters = qp_solve(blocks, xs)
            dX, dU = Xq - X, Uq - U
        if qp_iters is not None:
            qp_log.append(torch.where(done, 0, qp_iters).to(torch.int32))

        merits = merit(
            model, cost_cfg, sqp_cfg.merit_mu, X + cand * dX, U + cand * dU,
            goals, X[..., 0, :], dt, wrench_world,
        )
        ok = merits[:-1] <= merits[-1]
        any_ok = ok.any(0)
        first = ok.to(torch.int8).argmax(0)  # alphas descend: the first wins
        # index_select: indexing by a 0-d tensor (one lane) reads it on the host.
        alpha = torch.where(any_ok, alphas.index_select(0, first.reshape(-1)).reshape(first.shape),
                            0.0)

        # Masked update: once done (or rejected), the trajectory freezes.
        take = ~done & (alpha > 0.0)
        scale = torch.where(take, alpha, 0.0)
        X = X + scale[..., None, None] * dX
        U = U + scale[..., None, None] * dU
        step_norm = scale * torch.sqrt((dX * dX).sum((-2, -1)) + (dU * dU).sum((-2, -1)))
        step_log.append(step_norm)
        alpha_log.append(torch.where(done, 0.0, alpha))
        iters = iters + (~done).to(torch.int32)

        # Levenberg rho: raise on rejection, keep on acceptance.
        rejected = ~done & ~any_ok
        rho = torch.clamp(
            torch.where(rejected, rho * sqp_cfg.rho_factor, rho),
            sqp_cfg.rho, sqp_cfg.rho_max,
        )
        done = done | (take & (step_norm < sqp_cfg.step_tol))

    return SQPResult(
        X=X,
        U=U,
        state=SolverState(rho=rho.to(state.rho.dtype), admm_z=admm_z, admm_y=admm_y),
        stats=SQPStats(
            iterations=iters,
            step_sizes=torch.stack(step_log, -1),
            alphas=torch.stack(alpha_log, -1),
            pcg_iters=torch.stack(qp_log, -1) if qp_log else None,
        ),
    )


def batch_solve(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    xs_batch,
    goals_batch,
    X_batch,
    U_batch,
    state: Optional[SolverState] = None,
    wrench_world_batch=None,
) -> SQPResult:
    """Lane-batched solve (the reference's ``SQPSolverfloat_B.solve``).

    Every argument carries a leading lane axis B; ``wrench_world_batch``
    is (B, 6) or None.
    """
    return solve(
        model, cost_cfg, sqp_cfg, dt, xs_batch, goals_batch, X_batch, U_batch,
        state=state, wrench_world=wrench_world_batch,
    )


def batch_solve_fn(model: RobotModel, cost_cfg: CostConfig, sqp_cfg: SQPConfig, dt: float):
    """``(xs_b, goals_b, X_b, U_b, wrench_b) -> SQPResult`` on this solver,
    the signature every tick takes its batched solver in."""
    return lambda xs, g, X, U, w: batch_solve(
        model, cost_cfg, sqp_cfg, dt, xs, g, X, U, wrench_world_batch=w
    )

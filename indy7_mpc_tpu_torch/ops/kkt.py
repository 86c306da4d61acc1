"""Per-knot dynamics linearization and cost blocks (port of ``ops/kkt.py``).

Instead of the reference's sparse-CSC KKT assembly feeding OSQP, these
functions produce structured dense per-knot blocks
``(A_k, B_k, c_k, Q_k, q_k, R_k, r_k)`` that flow straight into the
Riccati sweep (ops/riccati.py).  Every function broadcasts over leading
lane dims: ``X (*b, N, nx)``, ``U (*b, N-1, nu)``, ``goals (*b, N, 3)``,
wrenches ``(*b, 6)``; one lane is ``*b = ()``.

Semantics (the reference's osqp_solver.py / osqp_sqp.py):
  * Linearization uses the explicit-Euler step:
      A_k = [[I, dt I], [dt da/dq, I + dt da/dv]],  B_k = [[0], [dt da/du]],
      c_k = f(x_k, u_k) - A_k x_k - B_k u_k.
    A and B come from forward-mode autodiff of the same Euler step
    (``torch.func.jvp`` with the nx + nu basis tangents folded into a
    leading batch axis), so the external wrench's dependence on q is
    included exactly.
  * Cost blocks: the "reference" formulation (absolute variables, the
    rank-1 position Hessian ``outer(J^T err, J^T err)``) and the "gn"
    formulation (delta variables, the Gauss-Newton Hessian ``2 J^T J``
    plus the joint-range barrier).  Velocity and control weights are
    scaled by ``1/(|ee_err| + eps)`` when ``cfg.regularize`` is on.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import CostConfig
from ..dynamics.integrators import euler_step
from ..dynamics.kinematics import ee_pos, ee_pos_jacobian
from ..dynamics.rnea import world_wrench_to_ee_joint
from ..models.robot import RobotModel


class QPBlocks(NamedTuple):
    """Structured block-tridiagonal QP data.

    Shapes (one lane; lanes lead): A (N-1, nx, nx), B (N-1, nx, nu),
    c (N-1, nx), Q (N, nx, nx), q (N, nx), R (N-1, nu, nu), r (N-1, nu).
    """

    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor
    Q: torch.Tensor
    q: torch.Tensor
    R: torch.Tensor
    r: torch.Tensor


def make_step_fn(model: RobotModel, dt: float, wrench_world=None):
    """Euler step closure, optionally under a world-frame EE wrench.

    ``wrench_world``: (*b, 6) spatial force in world coordinates (moment
    about the world origin, the reference's convention), broadcast against
    the states.  It is re-mapped to the EE joint frame at every evaluated
    configuration, as the reference's CUDA solver does inside its rollouts.
    """

    def step(x, u):
        f_l = None
        if wrench_world is not None:
            f_l = world_wrench_to_ee_joint(model, x[..., : model.nq], wrench_world)
        return euler_step(model, x, u, dt, f_ext_ee=f_l)

    return step


def _knot_step(model, dt, f_ext_ee, wrench_world):
    """The Euler step with lane wrenches (*b, 6) broadcast over knots."""
    if wrench_world is not None:
        return make_step_fn(model, dt, wrench_world[..., None, :])
    f_l = None if f_ext_ee is None else f_ext_ee[..., None, :]
    return lambda x, u: euler_step(model, x, u, dt, f_ext_ee=f_l)


def linearize_dynamics(
    model: RobotModel,
    X,
    U,
    dt: float,
    f_ext_ee: Optional[torch.Tensor] = None,
    wrench_world: Optional[torch.Tensor] = None,
):
    """Euler-step Jacobians along a trajectory.

    Args:
      X: (*b, N, nx) states; U: (*b, N-1, nu) controls; f_ext_ee: optional
        (*b, 6) local EE wrench held constant along the horizon;
        wrench_world: optional (*b, 6) world wrench re-mapped per knot
        (takes precedence).
    Returns (A, B, c) with shapes (*b, N-1, nx, nx), (*b, N-1, nx, nu),
    (*b, N-1, nx).
    """
    step = _knot_step(model, dt, f_ext_ee, wrench_world)
    x, u = X[..., :-1, :], U
    nx, nu = x.shape[-1], u.shape[-1]
    nz = nx + nu
    # Tangent k is the k-th basis vector of (x, u): one forward-mode pass
    # over a leading axis of nz copies gives every column of [A B].
    eye = torch.eye(nz, dtype=x.dtype, device=x.device)
    lead = (nz,) + (1,) * (x.dim() - 1)
    # (Dual tensors need their own memory, so the copies are materialized.)
    xe = x.expand((nz,) + x.shape).contiguous()
    ue = u.expand((nz,) + u.shape).contiguous()
    tx = eye[:, :nx].reshape(lead + (nx,)).expand_as(xe).contiguous()
    tu = eye[:, nx:].reshape(lead + (nu,)).expand_as(ue).contiguous()
    fx, jac = torch.func.jvp(step, (xe, ue), (tx, tu))
    jac = jac.movedim(0, -1)  # (*b, N-1, nx, nz): d f_i / d z_k
    A, B = jac[..., :nx], jac[..., nx:]
    c = fx[0] - _mv(A, x) - _mv(B, u)
    return A, B, c


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _terminal_weights(cfg: CostConfig, N: int, like):
    """Q_mod per knot: 1 on running knots, QN on the terminal one."""
    return torch.cat([
        torch.ones(N - 1, dtype=like.dtype, device=like.device),
        torch.full((1,), cfg.QN, dtype=like.dtype, device=like.device),
    ])


def _cost_scale(cfg: CostConfig, err):
    """1 / (|ee_err| + eps) with regularization, else 1 (per knot)."""
    if cfg.regularize:
        return 1.0 / (torch.linalg.norm(err, dim=-1) + cfg.eps)
    return torch.ones_like(err[..., 0])


def _block_diag(Qpp, Qvv):
    """[[Qpp, 0], [0, Qvv]] over leading dims."""
    z = torch.zeros_like(Qpp)
    return torch.cat([torch.cat([Qpp, z], -1), torch.cat([z, Qvv], -1)], -2)


def cost_blocks(model: RobotModel, cfg: CostConfig, X, U, goals):
    """Cost blocks along a trajectory (reference formulation).

    Absolute-variable blocks mirroring osqp_solver.py: rank-1 position
    Hessian ``outer(J^T err, J^T err)``, gradient ``J^T err``.
    Returns (Q, q, R, r).
    """
    nq, nu, N = model.nq, model.nu, X.shape[-2]
    eep, J = ee_pos_jacobian(model, X[..., :nq])
    err = eep - goals
    joint_err = torch.einsum("...ji,...j->...i", J, err)  # J^T err, (*b, N, nq)
    scale = _cost_scale(cfg, err)
    dQ_mod, R_mod = cfg.dQ * scale, cfg.R * scale
    Q_mod = _terminal_weights(cfg, N, X)
    eye_q = torch.eye(nq, dtype=X.dtype, device=X.device)
    Q = _block_diag(
        Q_mod[:, None, None] * joint_err[..., :, None] * joint_err[..., None, :],
        dQ_mod[..., None, None] * eye_q,
    )
    q = torch.cat([Q_mod[:, None] * joint_err, dQ_mod[..., None] * X[..., nq:]], -1)
    eye_u = torch.eye(nu, dtype=X.dtype, device=X.device)
    R = R_mod[..., :-1, None, None] * eye_u
    r = R_mod[..., :-1, None] * U
    return Q, q, R, r


def barrier_terms(model: RobotModel, cfg: CostConfig, q):
    """Joint-range barrier value / gradient / GN Hessian diagonal at q.

    ``q_barrier * sum_j relu(q_j - (hi_j - m))^2 + relu((lo_j + m) - q_j)^2``
    (summed over the last axis), zero (value, gradient, curvature)
    strictly inside the margin band, so interior trajectories are
    unchanged with the barrier on.
    """
    w = cfg.q_barrier
    d_hi = torch.clamp(q - (model.q_upper - cfg.q_barrier_margin), min=0.0)
    d_lo = torch.clamp((model.q_lower + cfg.q_barrier_margin) - q, min=0.0)
    val = w * (d_hi * d_hi + d_lo * d_lo).sum(-1)
    grad = 2.0 * w * (d_hi - d_lo)
    hess = 2.0 * w * ((d_hi > 0.0) | (d_lo > 0.0)).to(q.dtype)
    return val, grad, hess


def cost_blocks_gn(model: RobotModel, cfg: CostConfig, X, U, goals):
    """Delta-variable Gauss-Newton cost blocks (the default formulation).

    Models the same nonlinear cost as :func:`eepos_cost` —
    ``sum Q_mod |ee err|^2 + dQ |v|^2 + R |u|^2`` — as
    ``0.5 d^T H d + g^T d`` around the current trajectory, with the GN
    Hessian ``2 Q_mod J^T J`` (rank 3) instead of the reference's rank-1
    outer product, plus the joint-range barrier.
    """
    nq, nu, N = model.nq, model.nu, X.shape[-2]
    eep, J = ee_pos_jacobian(model, X[..., :nq])
    err = eep - goals
    scale = _cost_scale(cfg, err)
    dQ_mod, R_mod = cfg.dQ * scale, cfg.R * scale
    Q_mod = _terminal_weights(cfg, N, X)
    eye_q = torch.eye(nq, dtype=X.dtype, device=X.device)
    Qpp = 2.0 * Q_mod[:, None, None] * (J.transpose(-1, -2) @ J)
    g_pos = 2.0 * Q_mod[:, None] * torch.einsum("...ji,...j->...i", J, err)
    if cfg.q_barrier:
        _, gb, hb = barrier_terms(model, cfg, X[..., :nq])
        Qpp = Qpp + torch.diag_embed(Q_mod[:, None] * hb)
        g_pos = g_pos + Q_mod[:, None] * gb
    Q = _block_diag(Qpp, 2.0 * dQ_mod[..., None, None] * eye_q)
    q = torch.cat([g_pos, 2.0 * dQ_mod[..., None] * X[..., nq:]], -1)
    eye_u = torch.eye(nu, dtype=X.dtype, device=X.device)
    R = 2.0 * R_mod[..., :-1, None, None] * eye_u
    r = 2.0 * R_mod[..., :-1, None] * U
    return Q, q, R, r


def dynamics_defects(
    model: RobotModel,
    X,
    U,
    dt: float,
    f_ext_ee: Optional[torch.Tensor] = None,
    wrench_world: Optional[torch.Tensor] = None,
):
    """Per-knot integrator defects ``d_k = f(x_k, u_k) - x_{k+1}``."""
    step = _knot_step(model, dt, f_ext_ee, wrench_world)
    return step(X[..., :-1, :], U) - X[..., 1:, :]


def build_qp(
    model: RobotModel,
    cfg: CostConfig,
    X,
    U,
    goals,
    dt: float,
    f_ext_ee: Optional[torch.Tensor] = None,
    wrench_world: Optional[torch.Tensor] = None,
) -> QPBlocks:
    """Absolute-variable QP blocks (reference formulation).

    The QP is over the trajectory variables themselves; its affine term
    ``c`` is the linearization residual.
    """
    A, B, c = linearize_dynamics(
        model, X, U, dt, f_ext_ee=f_ext_ee, wrench_world=wrench_world
    )
    Q, q, R, r = cost_blocks(model, cfg, X, U, goals)
    return QPBlocks(A=A, B=B, c=c, Q=Q, q=q, R=R, r=r)


def build_qp_gn(
    model: RobotModel,
    cfg: CostConfig,
    X,
    U,
    goals,
    dt: float,
    f_ext_ee: Optional[torch.Tensor] = None,
    wrench_world: Optional[torch.Tensor] = None,
) -> QPBlocks:
    """Delta-variable Gauss-Newton QP blocks (default formulation).

    The QP is over steps ``(dX, dU)``; the dynamics affine term is the
    integrator defect, and the initial condition is ``xs - x_0``.
    """
    A, B, c = linearize_dynamics(
        model, X, U, dt, f_ext_ee=f_ext_ee, wrench_world=wrench_world
    )
    # Defect d_k = f(x_k, u_k) - x_{k+1}, recovered from the residual c
    # without re-evaluating the dynamics.
    d = c + _mv(A, X[..., :-1, :]) + _mv(B, U) - X[..., 1:, :]
    Q, q, R, r = cost_blocks_gn(model, cfg, X, U, goals)
    return QPBlocks(A=A, B=B, c=d, Q=Q, q=q, R=R, r=r)


# ---------------------------------------------------------------------------
# Nonlinear merit components (the reference's osqp_sqp.py).
# ---------------------------------------------------------------------------

def eepos_cost(model: RobotModel, cfg: CostConfig, X, U, goals):
    """Nonlinear tracking cost, matching the reference's osqp_sqp.py.

    Unlike the QP blocks, the merit cost does NOT apply the adaptive
    1/(|err|+eps) scaling.  The joint-range barrier joins the position
    cost in the "gn" formulation only.  Returns (qcost, vcost, ucost),
    each of shape (*b,).
    """
    nq, N = model.nq, X.shape[-2]
    err = ee_pos(model, X[..., :nq]) - goals
    pos_cost = (err * err).sum(-1)
    if cfg.q_barrier and cfg.formulation == "gn":
        pos_cost = pos_cost + barrier_terms(model, cfg, X[..., :nq])[0]
    qc = (_terminal_weights(cfg, N, X) * pos_cost).sum(-1)
    v = X[..., nq:]
    vc = (cfg.dQ * (v * v).sum(-1)).sum(-1)
    uc = cfg.R * (U * U).sum((-2, -1))
    return qc, vc, uc


def integrator_err(
    model: RobotModel,
    X,
    U,
    dt: float,
    f_ext_ee: Optional[torch.Tensor] = None,
    wrench_world: Optional[torch.Tensor] = None,
):
    """Sum of per-knot Euler-defect norms: ||q_next - q_{k+1}|| +
    ||v_next - v_{k+1}|| per knot, as the reference sums them."""
    nq = model.nq
    d = dynamics_defects(model, X, U, dt, f_ext_ee=f_ext_ee, wrench_world=wrench_world)
    errs = torch.linalg.norm(d[..., :nq], dim=-1) + torch.linalg.norm(d[..., nq:], dim=-1)
    return errs.sum(-1)

"""Gauss-Newton SQP for end-effector tracking, written plainly.

One lane's problem: states X (N, 12) and torques U (N-1, 6) under the
Euler dynamics of :func:`rbd.euler_step` with the lane's world wrench,
the first state pinned to the measured one, and the cost

    sum_k Qk |ee(q_k) - g_k|^2 + barrier(q_k) Qk + dQ |v_k|^2  +  R sum_k |u_k|^2

with Qk = 1 on running knots and QN on the last.  Each iteration
linearizes the dynamics (A, B by forward-mode differentiation), builds the
Gauss-Newton blocks (the velocity and torque weights scaled by
1 / (|ee error| + eps) where ``regularize``), solves the equality-
constrained QP by a Riccati sweep with a Levenberg term rho on Quu, rolls
the linear model out from a zero initial deviation, and takes the largest
of ``num_alphas`` halving steps whose merit (the cost plus ``merit_mu``
times the Euler defect norms and the first state's deviation) does not
exceed the current merit.  A lane stops once a taken step's norm falls
under ``step_tol``; a lane with no acceptable step raises its rho.

Every lane of a call is independent; tensors carry a leading lane axis L
and any float dtype.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch
import torch.autograd.forward_ad as fwAD

from . import rbd
from .robot import Robot

NX, NU, NQ = 12, 6, 6


@dataclass(frozen=True)
class SQPSettings:
    """The solver's settings as the configuration file states them."""

    dQ: float
    R: float
    QN: float
    regularize: bool
    eps: float
    q_barrier: float
    q_barrier_margin: float
    max_iters: int
    merit_mu: float
    num_alphas: int
    step_tol: float
    rho: float
    rho_max: float
    rho_factor: float


def linearize(robot: Robot, X, U, wrench, dt: float):
    """A (L, N-1, 12, 12), B (L, N-1, 12, 6) and the defects d (L, N-1, 12)
    of the Euler dynamics at every running knot.  The 18 directions of
    (x, u) go through one forward-mode pass, each a copy of the knots."""
    L, Nm1 = U.shape[0], U.shape[1]
    xs = X[:, :-1].reshape(-1, NX)
    us = U.reshape(-1, NU)
    ws = wrench[:, None, :].expand(L, Nm1, 6).reshape(-1, 6)
    K = xs.shape[0]
    eye = torch.eye(NX + NU, dtype=X.dtype)[:, None, :].expand(NX + NU, K, NX + NU)
    with fwAD.dual_level():
        # Constants as duals with zero tangents: forward AD is far slower
        # where plain and dual tensors mix.
        const = lambda t: fwAD.make_dual(t, torch.zeros_like(t))
        robot = Robot(**{f.name: const(getattr(robot, f.name)) for f in fields(Robot)})
        x = fwAD.make_dual(xs.expand(NX + NU, K, NX).clone(), eye[..., :NX].clone())
        u = fwAD.make_dual(us.expand(NX + NU, K, NU).clone(), eye[..., NX:].clone())
        out = fwAD.unpack_dual(rbd.euler_step(robot, x, u, dt, const(ws.expand(NX + NU, K, 6).clone())))
    nxt, jac = out.primal[0], out.tangent.permute(1, 2, 0)  # (K, 12, 18)
    d = nxt.reshape(L, Nm1, NX) - X[:, 1:]
    return (jac[..., :NX].reshape(L, Nm1, NX, NX), jac[..., NX:].reshape(L, Nm1, NX, NU), d)


def _barrier(robot: Robot, s: SQPSettings, q):
    """Value, gradient and Hessian diagonal of the joint-range barrier."""
    over = torch.clamp(q - (robot.q_hi - s.q_barrier_margin), min=0.0)
    under = torch.clamp((robot.q_lo + s.q_barrier_margin) - q, min=0.0)
    value = s.q_barrier * (over * over + under * under).sum(-1)
    grad = 2.0 * s.q_barrier * (over - under)
    hess = 2.0 * s.q_barrier * ((over > 0) | (under > 0)).to(q.dtype)
    return value, grad, hess


def _knot_weights(N: int, s: SQPSettings, dtype):
    w = torch.ones(N, dtype=dtype)
    w[-1] = s.QN
    return w


def cost_blocks(robot: Robot, s: SQPSettings, X, U, goals):
    """Gauss-Newton Hessian blocks Q (L, N, 12, 12), gradients q (L, N, 12),
    the torque weight r_w (L, N-1) and torque gradient r (L, N-1, 6)."""
    L, N = X.shape[0], X.shape[1]
    q, v = X[..., :NQ], X[..., NQ:]
    p, J = rbd.ee_jacobian(robot, q)
    err = p - goals
    scale = 1.0 / (torch.sqrt((err * err).sum(-1)) + s.eps) if s.regularize \
        else torch.ones_like(err[..., 0])
    Qk = _knot_weights(N, s, X.dtype)[None, :, None]
    Q = torch.zeros(L, N, NX, NX, dtype=X.dtype)
    g = torch.zeros(L, N, NX, dtype=X.dtype)
    Jt = J.transpose(-1, -2)
    Q[..., :NQ, :NQ] = 2.0 * Qk[..., None] * (Jt @ J)
    g[..., :NQ] = 2.0 * Qk * rbd.mv(Jt, err)
    if s.q_barrier:
        _, gb, hb = _barrier(robot, s, q)
        Q[..., :NQ, :NQ] = Q[..., :NQ, :NQ] + torch.diag_embed(Qk * hb)
        g[..., :NQ] = g[..., :NQ] + Qk * gb
    wv = 2.0 * s.dQ * scale
    Q[..., NQ:, NQ:] = torch.diag_embed(wv[..., None].expand(L, N, NQ))
    g[..., NQ:] = wv[..., None] * v
    r_w = 2.0 * s.R * scale[:, :-1]
    return Q, g, r_w, r_w[..., None] * U


def riccati(A, B, d, Q, g, r_w, r, rho):
    """The QP's step (dX (L, N, 12), dU (L, N-1, 6)) from a zero initial
    deviation, by a backward Riccati sweep and a forward rollout."""
    L, Nm1 = B.shape[0], B.shape[1]
    eye_u = torch.eye(NU, dtype=A.dtype)
    S, s = Q[:, -1], g[:, -1]
    K, k = [None] * Nm1, [None] * Nm1
    for t in range(Nm1 - 1, -1, -1):
        At, Bt = A[:, t], B[:, t]
        Att, Btt = At.transpose(-1, -2), Bt.transpose(-1, -2)
        sc = rbd.mv(S, d[:, t]) + s
        Qxx = Att @ S @ At + Q[:, t]
        Quu = Btt @ S @ Bt + (r_w[:, t] + rho)[:, None, None] * eye_u
        Qxu = Att @ S @ Bt
        qx = rbd.mv(Att, sc) + g[:, t]
        qu = rbd.mv(Btt, sc) + r[:, t]
        sol = rbd.spd_solve(Quu, torch.cat([Qxu.transpose(-1, -2), qu[..., None]], -1))
        K[t], k[t] = -sol[..., :NX], -sol[..., NX]
        S = Qxx + Qxu @ K[t]
        S = 0.5 * (S + S.transpose(-1, -2))
        s = qx + rbd.mv(Qxu, k[t])
    dx = torch.zeros_like(d[:, 0])
    dX, dU = [dx], []
    for t in range(Nm1):
        du = rbd.mv(K[t], dx) + k[t]
        dx = rbd.mv(A[:, t], dx) + rbd.mv(B[:, t], du) + d[:, t]
        dX.append(dx)
        dU.append(du)
    return torch.stack(dX, 1), torch.stack(dU, 1)


def merit(robot: Robot, s: SQPSettings, X, U, goals, x0, wrench, dt: float):
    """Cost plus merit_mu times the constraint violation, for candidates
    X (..., L, N, 12), U (..., L, N-1, 6); ``x0`` (L, 12) is the pinned
    first state."""
    N = X.shape[-2]
    q, v = X[..., :NQ], X[..., NQ:]
    err = rbd.ee_position(robot, q) - goals
    pos = (err * err).sum(-1)
    if s.q_barrier:
        pos = pos + _barrier(robot, s, q)[0]
    cost = (_knot_weights(N, s, X.dtype) * pos + s.dQ * (v * v).sum(-1)).sum(-1) \
        + s.R * (U * U).sum((-1, -2))
    w = wrench[:, None, :].expand(*X.shape[:-2], N - 1, 6)
    pred = rbd.euler_step(robot, X[..., :-1, :], U, dt, w)
    diff = pred - X[..., 1:, :]
    dq = torch.sqrt((diff[..., :NQ] ** 2).sum(-1) + 1e-30)
    dv = torch.sqrt((diff[..., NQ:] ** 2).sum(-1) + 1e-30)
    dx0 = X[..., 0, :] - x0
    violation = (dq + dv).sum(-1) + torch.sqrt((dx0 * dx0).sum(-1) + 1e-30)
    return cost + s.merit_mu * violation


def solve(robot: Robot, s: SQPSettings, dt: float, x0, goals, X, U, wrench):
    """``max_iters`` SQP iterations on L lanes: x0 (L, 12), goals (L, N, 3),
    warm start X (L, N, 12), U (L, N-1, 6), wrench (L, 6).  Returns the
    solution (X, U); X's first state is x0."""
    L = x0.shape[0]
    dtype = X.dtype
    X = X.clone()
    X[:, 0] = x0
    rho = torch.full((L,), s.rho, dtype=dtype)
    alphas = 0.5 ** torch.arange(s.num_alphas, dtype=dtype)
    cand = torch.cat([alphas, torch.zeros(1, dtype=dtype)])
    done = torch.zeros((L,), dtype=torch.bool)
    zero = torch.zeros((), dtype=dtype)
    for _ in range(s.max_iters):
        A, B, d = linearize(robot, X, U, wrench, dt)
        Q, g, r_w, r = cost_blocks(robot, s, X, U, goals)
        dX, dU = riccati(A, B, d, Q, g, r_w, r, rho)
        c = cand[:, None, None, None]
        merits = merit(robot, s, X + c * dX, U + c * dU, goals, X[:, 0], wrench, dt)
        ok = merits[:-1] <= merits[-1]
        found = ok.any(0)
        alpha = torch.where(found, alphas[ok.to(torch.int8).argmax(0)], zero)
        take = ~done & (alpha > 0)
        a = torch.where(take, alpha, zero)
        X = X + a[:, None, None] * dX
        U = U + a[:, None, None] * dU
        norm = a * torch.sqrt((dX * dX).sum((1, 2)) + (dU * dU).sum((1, 2)))
        rejected = ~done & ~found
        rho = torch.clamp(torch.where(rejected, rho * s.rho_factor, rho), s.rho, s.rho_max)
        done = done | (take & (norm < s.step_tol))
    return X, U

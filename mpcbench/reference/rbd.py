"""Plain rigid-body dynamics of a serial chain (Featherstone's algorithms in
spatial vectors), and the plant built on them.

Every function takes tensors with any leading batch shape and works in
their dtype, bfloat16 included (:func:`spd_solve`).  States are ``x = [q (6), v (6)]``,
controls are joint torques ``u (6)``, and a wrench is ``[f (3), n (3)]`` in
the world frame, its moment about the world origin.  The end effector is
the origin of the last joint's frame.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .robot import Robot

NJ = 6


def skew(a: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) with skew(a) @ b = a x b."""
    z = torch.zeros_like(a[..., 0])
    return torch.stack([
        torch.stack([z, -a[..., 2], a[..., 1]], -1),
        torch.stack([a[..., 2], z, -a[..., 0]], -1),
        torch.stack([-a[..., 1], a[..., 0], z], -1),
    ], -2)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def mv(M, v):
    return (M @ v[..., None])[..., 0]


def rot(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation by ``angle`` (...,) about the unit ``axis`` (3,) (Rodrigues)."""
    c, s = torch.cos(angle)[..., None, None], torch.sin(angle)[..., None, None]
    eye = torch.eye(3, dtype=angle.dtype)
    return c * eye + s * skew(axis) + (1.0 - c) * torch.outer(axis, axis)


def joint_rotations(robot: Robot, q) -> list:
    """Each joint frame's orientation in its parent's frame at ``q``."""
    return [robot.R[i] @ rot(robot.axis[i], q[..., i]) for i in range(NJ)]


def forward_kinematics(robot: Robot, q):
    """World orientation and origin of every joint frame: lists of
    (..., 3, 3) and (..., 3)."""
    Rs, ps, R_w, p_w = [], [], None, None
    for i, R_i in enumerate(joint_rotations(robot, q)):
        if i == 0:
            R_w, p_w = R_i, robot.p[0].expand(*q.shape[:-1], 3)
        else:
            p_w = p_w + mv(R_w, robot.p[i])
            R_w = R_w @ R_i
        Rs.append(R_w)
        ps.append(p_w)
    return Rs, ps


def ee_position(robot: Robot, q):
    return forward_kinematics(robot, q)[1][-1]


def ee_jacobian(robot: Robot, q):
    """End-effector position (..., 3) and its position Jacobian (..., 3, 6)."""
    Rs, ps = forward_kinematics(robot, q)
    cols = [cross(mv(Rs[i], robot.axis[i]), ps[-1] - ps[i]) for i in range(NJ)]
    return ps[-1], torch.stack(cols, -1)


def wrench_in_ee(robot: Robot, q, wrench):
    """A world wrench as the spatial force (n, f) on the last link, about
    its joint origin, in its frame."""
    Rs, ps = forward_kinematics(robot, q)
    Rt = Rs[-1].transpose(-1, -2)
    f, n = wrench[..., :3], wrench[..., 3:]
    return mv(Rt, n - cross(ps[-1], f)), mv(Rt, f)


def _inertia_terms(robot: Robot):
    """Per link: mass, first moment h = m c, rotational inertia about the
    joint origin."""
    m, c = robot.mass, robot.com
    cc = (c * c).sum(-1)[:, None, None]
    eye = torch.eye(3, dtype=c.dtype)
    I_o = robot.I_com + m[:, None, None] * (cc * eye - c[:, :, None] * c[:, None, :])
    return m, m[:, None] * c, I_o


def rnea(robot: Robot, q, v, a, f_ext=None, Rj=None):
    """Joint torques (..., 6) of the motion (q, v, a) under gravity, with
    ``f_ext`` ((n, f) on the last link, :func:`wrench_in_ee`) acting on it."""
    Rj = joint_rotations(robot, q) if Rj is None else Rj
    m, h, I_o = _inertia_terms(robot)
    batch = q.shape[:-1]
    w = torch.zeros(*batch, 3, dtype=q.dtype)
    lin = torch.zeros_like(w)
    dw = torch.zeros_like(w)
    acc = (-robot.gravity).expand(*batch, 3)
    forces = []
    for i in range(NJ):
        E = Rj[i].transpose(-1, -2)  # parent -> child coordinates
        r, s = robot.p[i], robot.axis[i]
        # Motion transform of the parent's velocity and acceleration.
        w_i = mv(E, w)
        lin_i = mv(E, lin - cross(r.expand_as(w), w))
        dw_i = mv(E, dw)
        acc_i = mv(E, acc - cross(r.expand_as(dw), dw))
        vj = s * v[..., i:i + 1]
        w_i = w_i + vj
        # a_i += S qdd + v_i x vJ (spatial cross product of motions).
        dw_i = dw_i + s * a[..., i:i + 1] + cross(w_i, vj)
        acc_i = acc_i + cross(lin_i, vj)
        # f = I a + v x* (I v).
        Iv_n = mv(I_o[i], w_i) + cross(h[i].expand_as(lin_i), lin_i)
        Iv_f = m[i] * lin_i - cross(h[i].expand_as(w_i), w_i)
        n_i = mv(I_o[i], dw_i) + cross(h[i].expand_as(acc_i), acc_i)
        f_i = m[i] * acc_i - cross(h[i].expand_as(dw_i), dw_i)
        n_i = n_i + cross(w_i, Iv_n) + cross(lin_i, Iv_f)
        f_i = f_i + cross(w_i, Iv_f)
        if f_ext is not None and i == NJ - 1:
            n_i, f_i = n_i - f_ext[0], f_i - f_ext[1]
        forces.append([n_i, f_i])
        w, lin, dw, acc = w_i, lin_i, dw_i, acc_i
    tau = [None] * NJ
    for i in range(NJ - 1, -1, -1):
        n_i, f_i = forces[i]
        tau[i] = (n_i * robot.axis[i]).sum(-1)
        if i > 0:  # the force transform to the parent: X^T
            Rp = Rj[i]
            f_p = mv(Rp, f_i)
            forces[i - 1][0] = forces[i - 1][0] + mv(Rp, n_i) + cross(robot.p[i].expand_as(f_p), f_p)
            forces[i - 1][1] = forces[i - 1][1] + f_p
    return torch.stack(tau, -1)


def _motion_transform(E, r):
    """6x6 transform of motion vectors [w; v] into a child frame rotated by
    E (parent -> child) at origin r (parent coordinates)."""
    z = torch.zeros_like(E)
    top = torch.cat([E, z], -1)
    bot = torch.cat([-E @ skew(r).expand_as(E), E], -1)
    return torch.cat([top, bot], -2)


def mass_matrix(robot: Robot, q, Rj=None):
    """Joint-space inertia (..., 6, 6) by the composite-rigid-body algorithm."""
    Rj = joint_rotations(robot, q) if Rj is None else Rj
    m, h, I_o = _inertia_terms(robot)
    batch = q.shape[:-1]
    eye = torch.eye(3, dtype=q.dtype)
    X, IC = [], []
    for i in range(NJ):
        E = Rj[i].transpose(-1, -2)
        X.append(_motion_transform(E, robot.p[i]))
        hx = skew(h[i])
        Ii = torch.cat([torch.cat([I_o[i], hx], -1),
                        torch.cat([hx.transpose(-1, -2), m[i] * eye], -1)], -2)
        IC.append(Ii.expand(*batch, 6, 6))
    for i in range(NJ - 1, 0, -1):
        Xt = X[i].transpose(-1, -2)
        IC[i - 1] = IC[i - 1] + Xt @ IC[i] @ X[i]
    S = [torch.cat([robot.axis[i], torch.zeros(3, dtype=q.dtype)]) for i in range(NJ)]
    M = [[None] * NJ for _ in range(NJ)]
    for i in range(NJ):
        F = mv(IC[i], S[i])
        M[i][i] = (S[i] * F).sum(-1)
        for j in range(i, 0, -1):
            F = mv(X[j].transpose(-1, -2), F)
            M[i][j - 1] = M[j - 1][i] = (S[j - 1] * F).sum(-1)
    return torch.stack([torch.stack(row, -1) for row in M], -2)


def spd_solve(A, B):
    """A^-1 B for symmetric positive definite A (..., n, n) and B (..., n, k)
    by a Cholesky factorization: ``torch.linalg``'s in float32 and float64,
    written out in any other dtype (bfloat16 has no ``torch.linalg``).  A
    matrix that is not positive definite gives NaN, never an exception."""
    if A.dtype in (torch.float32, torch.float64):
        L, info = torch.linalg.cholesky_ex(A)
        x = torch.cholesky_solve(B, L)
        return torch.where((info == 0)[..., None, None], x, torch.full_like(x, float("nan")))
    n = A.shape[-1]
    Lm = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[..., j, j] - sum((Lm[j][k] * Lm[j][k] for k in range(j)),
                               torch.zeros_like(A[..., j, j]))
        Lm[j][j] = torch.sqrt(d)
        for i in range(j + 1, n):
            s = A[..., i, j] - sum((Lm[i][k] * Lm[j][k] for k in range(j)),
                                   torch.zeros_like(A[..., i, j]))
            Lm[i][j] = s / Lm[j][j]
    y = []
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - Lm[i][k][..., None] * y[k]
        y.append(s / Lm[i][i][..., None])
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - Lm[k][i][..., None] * xs[k]
        xs[i] = s / Lm[i][i][..., None]
    return torch.stack(xs, -2)


def forward_dynamics(robot: Robot, q, v, tau, f_ext=None):
    """Joint accelerations M(q)^-1 (tau - bias(q, v, f_ext))."""
    Rj = joint_rotations(robot, q)
    bias = rnea(robot, q, v, torch.zeros_like(v), f_ext, Rj)
    return spd_solve(mass_matrix(robot, q, Rj), (tau - bias)[..., None])[..., 0]


def euler_step(robot: Robot, x, u, dt: float, wrench=None):
    """The SQP's dynamics: one explicit Euler step."""
    q, v = x[..., :NJ], x[..., NJ:]
    f_ext = None if wrench is None else wrench_in_ee(robot, q, wrench)
    a = forward_dynamics(robot, q, v, u, f_ext)
    return torch.cat([q + dt * v, v + dt * a], -1)


def rk4_step(robot: Robot, x, u, dt: float, wrench=None, friction=None):
    """One classical RK4 step of [q, v]; the wrench is mapped to the end
    effector once, at the start state; ``friction=(kv, kc)`` adds
    -kv v - kc tanh(v / 0.01) to the torque at every stage."""
    q, v = x[..., :NJ], x[..., NJ:]
    f_ext = None if wrench is None else wrench_in_ee(robot, q, wrench)

    def acc(qq, vv):
        tau = u
        if friction is not None:
            tau = u - friction[0] * vv - friction[1] * torch.tanh(vv / 0.01)
        return forward_dynamics(robot, qq, vv, tau, f_ext)

    k1q, k1v = v, acc(q, v)
    k2q = v + 0.5 * dt * k1v
    k2v = acc(q + 0.5 * dt * k1q, k2q)
    k3q = v + 0.5 * dt * k2v
    k3v = acc(q + 0.5 * dt * k2q, k3q)
    k4q = v + dt * k3v
    k4v = acc(q + dt * k3q, k4q)
    return torch.cat([q + dt / 6.0 * (k1q + 2 * k2q + 2 * k3q + k4q),
                      v + dt / 6.0 * (k1v + 2 * k2v + 2 * k3v + k4v)], -1)


def joint_stops(robot: Robot, x):
    """Positions held in their range; a velocity out of it is zeroed."""
    q, v = x[..., :NJ], x[..., NJ:]
    v = torch.where(q > robot.q_hi, torch.clamp(v, max=0.0), v)
    v = torch.where(q < robot.q_lo, torch.clamp(v, min=0.0), v)
    q = torch.minimum(torch.maximum(q, robot.q_lo), robot.q_hi)
    return torch.cat([q, v], -1)


def plant_step(robot: Robot, x, u, dt: float, wrench=None, substeps: int = 1,
               friction: Optional[Sequence[float]] = None, noise=None):
    """The plant over one period: torques clamped to the effort limits,
    ``substeps`` RK4 steps, each with its row of ``noise`` (..., substeps, 6)
    added to the torque and the joint stops applied after it."""
    u = torch.minimum(torch.maximum(u, -robot.effort), robot.effort)
    h = dt / substeps
    for s in range(substeps):
        us = u if noise is None else u + noise[..., s, :]
        x = joint_stops(robot, rk4_step(robot, x, us, h, wrench, friction))
    return x

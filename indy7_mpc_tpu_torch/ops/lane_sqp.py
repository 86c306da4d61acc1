"""Lane-major batched SQP internals: linearize, cost blocks, Riccati, merit.

Port of ``indy7_mpc_tpu/ops/lane_sqp.py``: the building blocks of the
plain PyTorch version of the SQP kernel (``solvers/sqp_lane.py``).

Array conventions (lane-major):
  X: (N, 12, B), U: (N-1, 6, B), goals: (N, 3, B), xs: (12, B),
  wrench: (6, B) or None.
Riccati blocks: A (N-1, 12, 12, B), Bm (N-1, 12, 6, B), d (N-1, 12, B),
  Q (N, 12, 12, B), q (N, 12, B), Rdiag (N-1, B), r (N-1, 6, B).

The Riccati sweep runs its small matrix products as batched ``einsum``s
over the lane axis; callers on a GPU keep TF32 off so that they stay
float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from ..config import CostConfig
from . import lane_rbd as LR

NX, NQ, NU = 12, 6, 6


# ---------------------------------------------------------------------------
# Linearization (Euler step Jacobians) and GN cost blocks.
# ---------------------------------------------------------------------------

def rnea_tangents(sm: LR.StaticModel, x, a, wrench=None):
    """d RNEA(q, v, a; f_ext(q)) / dx at x (12, L) with ``a`` (6, L) held
    fixed, the wrench map's q-dependence included: (6, 12, L).

    The 12 tangent directions fold into the lane axis through one
    forward-mode (``torch.autograd.forward_ad``) pass of RNEA.
    """
    L = x.shape[-1]
    dtype, device = x.dtype, x.device
    # Tangent block j = lanes [jL, (j+1)L) carries direction e_j.
    tangent = torch.kron(
        torch.eye(NX, dtype=dtype, device=device),
        torch.ones((1, L), dtype=dtype, device=device),
    )
    with fwAD.dual_level():
        # Every operand is dual (zero tangents for the constants): mixing
        # plain and dual tensors takes a far slower path in forward AD.
        def const(t):
            return fwAD.make_dual(t, torch.zeros_like(t))

        smd = LR.StaticModel(
            **{f: const(getattr(sm, f)) for f in LR.STATIC_FIELDS}
        )
        q, v = LR.split(fwAD.make_dual(x.repeat(1, NX), tangent))
        at = const(a.repeat(1, NX))
        wt = const(wrench.repeat(1, NX)) if wrench is not None else None
        fe = LR.f_ext_from_world(smd, q, wt)
        tau = LR.rnea(smd, q, v, [at[i] for i in range(NU)], f_ext_ee=fe)
        return fwAD.unpack_dual(torch.stack(tau)).tangent.reshape(NU, NX, L)


def linearize(sm: LR.StaticModel, x, u, dt: float, wrench=None):
    """Euler-step Jacobians on folded knots: x (12, L), u (6, L).

    Returns (A (12, 12, L), Bm (12, 6, L), xnext (12, L)).

    Uses the RNEA-transpose identity: along the solution
    ``tau = RNEA(q, v, a*; f_ext(q))``, so ``da/dx = -M^-1 dRNEA/dx`` with
    ``a*`` held fixed (:func:`rnea_tangents`), and ``da/du = M^-1`` from
    the already-factored mass matrix.
    """
    L = x.shape[-1]
    dtype, device = x.dtype, x.device
    q0, v0 = LR.split(x)
    fe0 = LR.f_ext_from_world(sm, q0, wrench)
    a0_l, fac = LR.forward_dynamics(sm, q0, v0, [u[i] for i in range(NU)], fe0)
    a0 = torch.stack(a0_l)
    dtau = rnea_tangents(sm, x, a0, wrench)

    # da/dx = -M^-1 dtau, one LDL solve broadcast over the 12 tangents.
    sol = LR.chol6_solve(fac, [dtau[i] for i in range(NU)])
    da_dx = -torch.stack(sol)  # (6 accel, 12 tangent, L)
    eye_cols = [
        LR.chol6_solve(fac, [1.0 if i == j else 0.0 for i in range(NU)])
        for j in range(NU)
    ]
    minv = torch.stack(
        [torch.stack(col) for col in eye_cols], dim=1
    )  # (i, j, L) = M^-1[i, j]

    A = torch.zeros((NX, NX, L), dtype=dtype, device=device)
    idx = torch.arange(NQ, device=device)
    A[idx, idx] = 1.0
    A[idx, idx + NQ] = dt
    A[NQ:] = dt * da_dx
    A[idx + NQ, idx + NQ] += 1.0
    Bm = torch.zeros((NX, NU, L), dtype=dtype, device=device)
    Bm[NQ:] = dt * minv

    xnext = torch.cat([x[:NQ] + dt * x[NQ:], x[NQ:] + dt * a0])
    return A, Bm, xnext


class LaneBlocks(NamedTuple):
    A: torch.Tensor   # (N-1, 12, 12, B)
    Bm: torch.Tensor  # (N-1, 12, 6, B)
    d: torch.Tensor   # (N-1, 12, B) defects
    Q: torch.Tensor   # (N, 12, 12, B)
    q: torch.Tensor   # (N, 12, B)
    Rdiag: torch.Tensor  # (N-1, B) control weight (scalar diagonal)
    r: torch.Tensor   # (N-1, 6, B)


def cost_scale(cfg: CostConfig, err_norm):
    if cfg.regularize:
        return 1.0 / (err_norm + cfg.eps)
    return torch.ones_like(err_norm)


def _barrier_bounds(sm: LR.StaticModel, cfg: CostConfig, i: int):
    c = sm.c
    return c["q_upper"][i] - cfg.q_barrier_margin, c["q_lower"][i] + cfg.q_barrier_margin


def build_blocks(
    sm: LR.StaticModel, cfg: CostConfig, X, U, goals, dt: float, wrench=None
) -> LaneBlocks:
    """Gauss-Newton delta-variable QP blocks, lane-major."""
    N, B = X.shape[0], X.shape[-1]
    dtype, device = X.dtype, X.device

    # --- dynamics: fold knots into lanes ---
    Lfold = (N - 1) * B
    xf = X[:-1].transpose(0, 1).reshape(NX, Lfold)
    uf = U.transpose(0, 1).reshape(NU, Lfold)
    wf = None
    if wrench is not None:
        wf = wrench[:, None, :].expand(6, N - 1, B).reshape(6, Lfold)
    Af, Bf, xnextf = linearize(sm, xf, uf, dt, wrench=wf)
    A = Af.reshape(NX, NX, N - 1, B).permute(2, 0, 1, 3)
    Bm = Bf.reshape(NX, NU, N - 1, B).permute(2, 0, 1, 3)
    d = xnextf.reshape(NX, N - 1, B).transpose(0, 1) - X[1:]

    # --- cost: fold all N knots ---
    Lc = N * B
    qf = [X[:, i].reshape(Lc) for i in range(NQ)]
    eep, cols = LR.ee_pos_jacobian(sm, qf)
    gf = goals.transpose(0, 1).reshape(3, Lc)
    err = [eep[i] - gf[i] for i in range(3)]
    err_norm = torch.sqrt(err[0] ** 2 + err[1] ** 2 + err[2] ** 2)
    scale = cost_scale(cfg, err_norm)
    dQ_mod = cfg.dQ * scale
    R_mod = cfg.R * scale
    term = (torch.arange(N, device=device) == N - 1)[:, None].expand(N, B)
    Q_mod = torch.where(
        term.reshape(Lc),
        torch.tensor(cfg.QN, dtype=dtype, device=device),
        torch.tensor(1.0, dtype=dtype, device=device),
    )

    Qblk = torch.zeros((NX, NX, Lc), dtype=dtype, device=device)
    for i in range(NQ):
        for j in range(i, NQ):
            v = 2.0 * Q_mod * LR.dot3(cols[i], cols[j])
            Qblk[i, j] = v
            Qblk[j, i] = v
    idx = torch.arange(NQ, device=device)
    Qblk[idx + NQ, idx + NQ] = (2.0 * dQ_mod).expand(NQ, Lc)
    grad = torch.zeros((NX, Lc), dtype=dtype, device=device)
    for i in range(NQ):
        grad[i] = 2.0 * Q_mod * LR.dot3(cols[i], err)
    vf = X[:, NQ:].transpose(0, 1).reshape(NQ, Lc)
    grad[NQ:] = 2.0 * dQ_mod * vf

    if cfg.q_barrier:  # joint-range barrier, scaled by Qmod like the EE term
        w_b = cfg.q_barrier
        for i in range(NQ):
            hi, lo = _barrier_bounds(sm, cfg, i)
            d_hi = torch.clamp(qf[i] - hi, min=0.0)
            d_lo = torch.clamp(lo - qf[i], min=0.0)
            gb = 2.0 * w_b * (d_hi - d_lo)
            hb = 2.0 * w_b * ((d_hi > 0.0) | (d_lo > 0.0)).to(dtype)
            Qblk[i, i] += Q_mod * hb
            grad[i] += Q_mod * gb

    Q = Qblk.reshape(NX, NX, N, B).permute(2, 0, 1, 3)
    qvec = grad.reshape(NX, N, B).transpose(0, 1)
    Rknots = (2.0 * R_mod).reshape(N, B)[:-1]
    r = Rknots[:, None, :] * U
    return LaneBlocks(A=A, Bm=Bm, d=d, Q=Q, q=qvec, Rdiag=Rknots, r=r)


# ---------------------------------------------------------------------------
# Riccati sweep.
# ---------------------------------------------------------------------------

def _mm(A, B):
    """Lane-batched (n, k, B) @ (k, m, B)."""
    return torch.einsum("ikb,kjb->ijb", A, B)


def _tmm(A, B):
    """Lane-batched A^T @ B for A (k, n, B), B (k, m, B)."""
    return torch.einsum("kib,kjb->ijb", A, B)


def _mv(A, x):
    return torch.einsum("ikb,kb->ib", A, x)


def _tmv(A, x):
    return torch.einsum("kib,kb->ib", A, x)


def riccati(blocks: LaneBlocks, xs_delta, rho):
    """Exact block-tridiagonal solve of the GN QP, lane-batched.

    xs_delta: (12, B) pinned initial delta state; rho: (B,) Levenberg term
    on Quu.  S is re-symmetrized at every knot.  Returns (dX (N, 12, B),
    dU (N-1, 6, B)).
    """
    Nm1 = blocks.A.shape[0]
    eye_u = torch.eye(NU, dtype=rho.dtype, device=rho.device)[:, :, None]
    S = blocks.Q[-1]
    s = blocks.q[-1]
    K = [None] * Nm1
    kff = [None] * Nm1
    for k in range(Nm1 - 1, -1, -1):
        A, Bm, d = blocks.A[k], blocks.Bm[k], blocks.d[k]
        Sc = _mv(S, d) + s
        SA = _mm(S, A)
        SB = _mm(S, Bm)
        Qxx = _tmm(A, SA) + blocks.Q[k]
        Quu = _tmm(Bm, SB) + (blocks.Rdiag[k] + rho) * eye_u
        Qxu = _tmm(A, SB)
        qx = _tmv(A, Sc) + blocks.q[k]
        qu = _tmv(Bm, Sc) + blocks.r[k]

        fac = LR.chol6([[Quu[i, j] for j in range(NU)] for i in range(NU)])
        # K = -Quu^-1 Qxu^T: one substitution with the 12 columns stacked.
        Kk = -torch.stack(LR.chol6_solve(fac, [Qxu[:, i] for i in range(NU)]))
        kk = -torch.stack(LR.chol6_solve(fac, [qu[i] for i in range(NU)]))
        S_new = Qxx + _mm(Qxu, Kk)
        S = 0.5 * (S_new + S_new.transpose(0, 1))
        s = qx + _mv(Qxu, kk)
        K[k], kff[k] = Kk, kk

    x = xs_delta
    dX, dU = [x], []
    for k in range(Nm1):
        u = _mv(K[k], x) + kff[k]
        x = _mv(blocks.A[k], x) + _mv(blocks.Bm[k], u) + blocks.d[k]
        dX.append(x)
        dU.append(u)
    return torch.stack(dX), torch.stack(dU)


# ---------------------------------------------------------------------------
# Merit (nonlinear cost + constraint violation), folded over candidates.
# ---------------------------------------------------------------------------

def merit_batch(
    sm: LR.StaticModel, cfg: CostConfig, mu: float, Xc, Uc, goals, x0_prev,
    dt: float, wrench=None,
):
    """Merit for a stack of candidates: Xc (C, N, 12, B) -> (C, B).

    eepos cost + mu * (Euler defect norms + initial-state deviation).
    """
    C, N, B = Xc.shape[0], Xc.shape[1], Xc.shape[-1]
    device = Xc.device
    Lc = C * N * B
    qf = [Xc[:, :, i].reshape(Lc) for i in range(NQ)]
    eep = LR.ee_pos(sm, qf)
    gf = goals[None].expand(C, N, 3, B)
    err2 = sum((eep[i] - gf[:, :, i].reshape(Lc)) ** 2 for i in range(3))
    term = (torch.arange(N, device=device) == N - 1)[None, :, None].expand(C, N, B)
    Q_mod = torch.where(term.reshape(Lc), cfg.QN, 1.0).to(Xc.dtype)
    v2 = sum(Xc[:, :, NQ + i].reshape(Lc) ** 2 for i in range(NQ))
    pos2 = err2
    if cfg.q_barrier:
        for i in range(NQ):
            hi, lo = _barrier_bounds(sm, cfg, i)
            d_hi = torch.clamp(qf[i] - hi, min=0.0)
            d_lo = torch.clamp(lo - qf[i], min=0.0)
            pos2 = pos2 + cfg.q_barrier * (d_hi * d_hi + d_lo * d_lo)
    knot_cost = Q_mod * pos2 + cfg.dQ * v2
    cost = knot_cost.reshape(C, N, B).sum(1) + cfg.R * (Uc * Uc).sum((1, 2))

    Ld = C * (N - 1) * B
    xf = Xc[:, :-1].permute(2, 0, 1, 3).reshape(NX, Ld)
    uf = Uc.permute(2, 0, 1, 3).reshape(NU, Ld)
    wf = None
    if wrench is not None:
        wf = wrench[:, None, None, :].expand(6, C, N - 1, B).reshape(6, Ld)
    pred = LR.euler_step(sm, xf, uf, dt, wrench_world=wf)
    nxt = Xc[:, 1:].permute(2, 0, 1, 3).reshape(NX, Ld)
    diff2 = (pred - nxt) ** 2
    dq = torch.sqrt(diff2[:NQ].sum(0) + 1e-30)
    dv = torch.sqrt(diff2[NQ:].sum(0) + 1e-30)
    defect = (dq + dv).reshape(C, N - 1, B).sum(1)
    dx0 = Xc[:, 0] - x0_prev[None]
    cv = defect + torch.sqrt((dx0 * dx0).sum(1) + 1e-30)
    return cost + mu * cv

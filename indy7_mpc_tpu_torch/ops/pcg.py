"""Schur-complement PCG solve of the block-tridiagonal KKT system (port of
``indy7_mpc_tpu/ops/pcg.py``).

The iterative QP backend of the reference's CUDA solver (GATO, whose
stats carry ``pcg_iterations`` per SQP iteration): eliminate the primal
variables of the equality-constrained QP and run preconditioned conjugate
gradients on the dual (multiplier) system

    S lam = gamma,      S = C H^{-1} C^T   (block tridiagonal, N x N
                                            blocks of nx x nx)

with the symmetric block-Jacobi preconditioner ``M_k = S_kk^{-1}``.

QP solved (the same as ops/riccati.py):

    min  sum_k 0.5 x_k^T Q_k x_k + q_k^T x_k
         + sum_{k<N-1} 0.5 u_k^T (R_k + rho I) u_k + r_k^T u_k
    s.t. x_0 = xs,   x_{k+1} = A_k x_k + B_k u_k + c_k

The Schur complement needs ``H^{-1}``, so every Q_k gets ``primal_reg *
I`` (both cost formulations give rank-deficient position blocks); pass
the same regularization to the Riccati solve when comparing.

Every lane at once (leading lane dims), in the inputs' dtype; the block
algebra is batched over the knot axis.  The CG loop is the lane-batched
while loop of ``ops/while_loop.py``: a lane stops at its own exit and
counts only its own iterations; every reduction runs over one lane.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .kkt import QPBlocks
from .riccati import _mv, _sym
from .while_loop import while_loop


class PCGSolution(NamedTuple):
    X: torch.Tensor           # (*b, N, nx)
    U: torch.Tensor           # (*b, N-1, nu)
    lam: torch.Tensor         # (*b, N, nx) multipliers
    iterations: torch.Tensor  # (*b,) int32 CG iterations used
    residual: torch.Tensor    # (*b,) final |S lam - gamma|


def _mtv(M, v):
    return torch.einsum("...ji,...j->...i", M, v)


def _dot(a, b):
    """Per-lane inner product over the knot and state axes."""
    return (a * b).sum((-2, -1))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _chol_inv(M):
    """Batched SPD inverse via Cholesky; M: (..., n, n).  No status read:
    a matrix that is not positive definite gives a wrong inverse, not a
    host sync."""
    L = torch.linalg.cholesky_ex(M)[0]
    eye = _eye(M.shape[-1], M).expand(M.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.mT @ Linv


def build_schur(blocks: QPBlocks, rho, primal_reg):
    """Form the dual Schur system ``S lam = gamma`` from QP blocks.

    Multiplier layout: lam_0 <-> (x_0 = xs); lam_{k+1} <-> dynamics row
    ``A_k x_k + B_k u_k - x_{k+1} = -c_k``.  ``rho``: a float or (*b,).

    Returns (D, Uo, g_dyn, W, V, Wq, Vr): D (*b, N, nx, nx) diagonal
    blocks, Uo (*b, N-1, nx, nx) superdiagonal blocks ``S_{k,k+1}``, g_dyn
    (*b, N-1, nx) the dynamics rows of the right-hand side (the
    initial-state row depends on xs and is assembled by the caller), W/V
    the inverted cost blocks and Wq/Vr their products with the gradients
    (reused for primal recovery).
    """
    A, B, c, Q, q, R, r = blocks
    nx, nu = Q.shape[-1], R.shape[-1]
    rho = torch.as_tensor(rho, dtype=Q.dtype, device=Q.device)[..., None, None, None]
    W = _chol_inv(_sym(Q) + primal_reg * _eye(nx, Q))     # (*b, N, nx, nx)
    V = _chol_inv(_sym(R) + rho * _eye(nu, R))            # (*b, N-1, nu, nu)

    AW = A @ W[..., :-1, :, :]                            # A_k W_k
    BV = B @ V                                            # B_k V_k

    # Diagonal: S_00 = W_0; S_{k+1,k+1} = A W A' + B V B' + W_{k+1}.
    D_dyn = AW @ A.mT + BV @ B.mT + W[..., 1:, :, :]
    D = torch.cat([W[..., :1, :, :], D_dyn], -3)

    # Superdiagonal: S_{0,1} = W_0 A_0'; S_{k+1,k+2} = -W_{k+1} A_{k+1}'.
    WAt = W[..., :-1, :, :] @ A.mT                        # W_k A_k'
    Uo = torch.cat([WAt[..., :1, :, :], -WAt[..., 1:, :, :]], -3)

    # RHS gamma = -(d + C H^{-1} g), d = (xs handled by caller, -c_k).
    Wq = _mv(W, q)                                        # W_k q_k
    Vr = _mv(V, r)                                        # V_k r_k
    g_dyn = -(-c + _mv(A, Wq[..., :-1, :]) + _mv(B, Vr) - Wq[..., 1:, :])
    return D, Uo, g_dyn, W, V, Wq, Vr


def _matvec(D, Uo, lam):
    """(S lam)_k = D_k lam_k + Uo_k lam_{k+1} + Uo_{k-1}' lam_{k-1}."""
    up = _mv(Uo, lam[..., 1:, :])                         # rows 0..N-2
    dn = _mtv(Uo, lam[..., :-1, :])                       # rows 1..N-1
    zero = torch.zeros_like(lam[..., :1, :])
    return _mv(D, lam) + torch.cat([up, zero], -2) + torch.cat([zero, dn], -2)


def solve(
    blocks: QPBlocks,
    xs,
    rho,
    primal_reg: float = 1e-6,
    tol: float = 1e-8,
    max_iters: int = 100,
) -> PCGSolution:
    """Solve the block-tridiagonal QP by dual PCG, every lane at once.
    ``xs`` (*b, nx) is the pinned initial state (or the initial-state
    delta of the GN formulation); ``rho`` a float or (*b,).  Matches
    ops/riccati.py's solve on the same blocks when ``primal_reg`` is added
    to Q on both sides.
    """
    A, B, c, Q, q, R, r = blocks
    D, Uo, g_dyn, W, V, Wq, Vr = build_schur(blocks, rho, primal_reg)
    gamma = torch.cat([-(xs + Wq[..., 0, :])[..., None, :], g_dyn], -2)

    Minv = _chol_inv(D)  # block-Jacobi preconditioner

    lam0 = torch.zeros_like(gamma)
    r0 = gamma - _matvec(D, Uo, lam0)
    z0 = _mv(Minv, r0)
    # Scale-aware exit, per lane: |r| <= tol * max(1, |gamma|).
    stop2 = (tol * torch.linalg.vector_norm(gamma, dim=(-2, -1)).clamp(min=1.0)) ** 2

    def cond(state):
        rvec = state[1]
        return _dot(rvec, rvec) > stop2

    def body(state):
        lam, rvec, z, p, rz = state
        Sp = _matvec(D, Uo, p)
        alpha = (rz / _dot(p, Sp))[..., None, None]
        lam = lam + alpha * p
        rvec = rvec - alpha * Sp
        z = _mv(Minv, rvec)
        rz_new = _dot(rvec, z)
        p = z + (rz_new / rz)[..., None, None] * p
        return lam, rvec, z, p, rz_new

    (lam, rvec, *_), iters = while_loop(cond, body, (lam0, r0, z0, z0, _dot(r0, z0)), max_iters)

    # Primal recovery: z = -H^{-1}(g + C' lam).
    # x_k picks up +lam_0 (k=0), +A_k' lam_{k+1} (k<N-1), -lam_k (k>0).
    ctl = _mtv(A, lam[..., 1:, :])                        # A_k' lam_{k+1}
    zero = torch.zeros_like(lam[..., :1, :])
    grad_x = (q + torch.cat([lam[..., :1, :], -lam[..., 1:, :]], -2)
              + torch.cat([ctl, zero], -2))
    X = -_mv(W, grad_x)
    U = -_mv(V, r + _mtv(B, lam[..., 1:, :]))
    return PCGSolution(X=X, U=U, lam=lam, iterations=iters,
                       residual=torch.linalg.vector_norm(rvec, dim=(-2, -1)))

"""Block-tridiagonal KKT solve by an affine Riccati sweep (port of
``ops/riccati.py``).

An exact O(N) backward/forward sweep over the horizon, batched over
leading lane dims; the readable counterpart of the sweep inside kernel K1.
The horizon recursion is a Python loop over knots; each step is a handful
of (nx+nu)-sized dense ops over all lanes at once.

QP solved (absolute variables, equality-constrained):

    min  sum_k 0.5 x_k^T Q_k x_k + q_k^T x_k
         + sum_{k<N-1} 0.5 u_k^T R_k u_k + r_k^T u_k
    s.t. x_0 = xs,   x_{k+1} = A_k x_k + B_k u_k + c_k

A Levenberg term ``rho * I`` is added to each Quu: the per-lane "rho"
solver state (the reference's ``resetRho``), which keeps the sweep
well-posed when the Gauss-Newton position Hessian is rank-deficient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..dynamics.rnea import lu_solve
from .kkt import QPBlocks


class RiccatiSolution(NamedTuple):
    X: torch.Tensor    # (*b, N, nx)
    U: torch.Tensor    # (*b, N-1, nu)
    K: torch.Tensor    # (*b, N-1, nu, nx) feedback gains
    kff: torch.Tensor  # (*b, N-1, nu) feedforward


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def backward_pass(blocks: QPBlocks, rho):
    """Backward Riccati recursion; returns gains (K, kff) per knot.

    ``rho``: a float or a (*b,) tensor of per-lane Levenberg terms."""
    nu = blocks.B.shape[-1]
    eye_u = torch.eye(nu, dtype=blocks.A.dtype, device=blocks.A.device)
    rho_I = torch.as_tensor(rho, dtype=blocks.A.dtype, device=blocks.A.device)[
        ..., None, None] * eye_u
    S, s = blocks.Q[..., -1, :, :], blocks.q[..., -1, :]
    Ks, kffs = [], []
    for k in range(blocks.A.shape[-3] - 1, -1, -1):
        A, B, c = blocks.A[..., k, :, :], blocks.B[..., k, :, :], blocks.c[..., k, :]
        Sc = s + _mv(S, c)
        AtS = A.transpose(-1, -2) @ S
        BtS = B.transpose(-1, -2) @ S
        Qxx = blocks.Q[..., k, :, :] + AtS @ A
        Quu = blocks.R[..., k, :, :] + BtS @ B + rho_I
        Qxu = AtS @ B
        qx = blocks.q[..., k, :] + torch.einsum("...ji,...j->...i", A, Sc)
        qu = blocks.r[..., k, :] + torch.einsum("...ji,...j->...i", B, Sc)

        # Pivoted LU rather than Cholesky: at N=64 the recursion drives
        # cond(Quu) past f32's range and a Cholesky pivot can go (float-)
        # negative, poisoning the whole lane with NaN; LU degrades to an
        # inaccurate step instead, which the merit line search simply
        # rejects (rho then escalates).  One solve for both right-hand
        # sides.
        sol = -lu_solve(_sym(Quu), torch.cat([Qxu.transpose(-1, -2), qu[..., None]], -1))
        K, kff = sol[..., :-1], sol[..., -1]
        S = _sym(Qxx + Qxu @ K)
        s = qx + _mv(Qxu, kff)
        Ks.append(K)
        kffs.append(kff)
    return torch.stack(Ks[::-1], -3), torch.stack(kffs[::-1], -2)


def forward_pass(blocks: QPBlocks, K, kff, xs):
    """Roll the affine policy forward from the pinned initial state."""
    x = xs
    Xs, Us = [], []
    for k in range(blocks.A.shape[-3]):
        u = _mv(K[..., k, :, :], x) + kff[..., k, :]
        Xs.append(x)
        Us.append(u)
        x = _mv(blocks.A[..., k, :, :], x) + _mv(blocks.B[..., k, :, :], u) + blocks.c[..., k, :]
    Xs.append(x)
    return torch.stack(Xs, -2), torch.stack(Us, -2)


def solve(blocks: QPBlocks, xs, rho) -> RiccatiSolution:
    """Exact solve of the block-tridiagonal QP, every lane at once.

    float32 blocks are always upcast to float64 for the sweep and the
    result cast back: the backward recursion squares the conditioning per
    knot, and at N=64 with QN=100 the accumulated S reaches cond(Quu) ~
    1e11, past float32's ~1e7.  (The TPU package upcasts only when JAX's
    x64 mode is on; PyTorch always has float64, so the port always does.
    Kernel K1 keeps float32 through its per-knot re-symmetrization.)
    """
    dtype = blocks.A.dtype
    if dtype == torch.float32:
        sol = solve(QPBlocks(*(b.double() for b in blocks)), xs.double(),
                    torch.as_tensor(rho).double())
        return RiccatiSolution(*(a.to(dtype) for a in sol))
    K, kff = backward_pass(blocks, rho)
    X, U = forward_pass(blocks, K, kff, xs)
    return RiccatiSolution(X=X, U=U, K=K, kff=kff)

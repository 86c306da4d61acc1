"""OSQP-style ADMM solve of the block-tridiagonal QP (port of
``indy7_mpc_tpu/ops/admm.py``).

The reference's CPU path hands its KKT system to OSQP, an ADMM solver on
sparse CSC matrices.  This is that algorithm on the structured per-knot
blocks every other backend takes (ops/kkt.py:QPBlocks): dense block
algebra over leading lane dims, no sparse matrices.

QP solved (the same as ops/riccati.py / ops/pcg.py):

    min  sum_k 0.5 x_k^T Q_k x_k + q_k^T x_k
         + sum_{k<N-1} 0.5 u_k^T (R_k + rho I) u_k + r_k^T u_k
    s.t. x_0 = xs,   x_{k+1} = A_k x_k + B_k u_k + c_k

In OSQP terms: decision variable z = (x_0,u_0,...,x_{N-1}) and constraint
set C = {b} (every row an equality, like the reference's ``l == u``
dynamics rows), so the projection step is ``b`` and the iteration is

    H z~          = sigma z^k - g + A^T (rho_admm b - y^k)
    z^{k+1}       = alpha z~ + (1-alpha) z^k
    y^{k+1}       = y^k + rho_admm alpha (A z~ - b)

with ``H = P + sigma I + rho_admm A^T A``, block tridiagonal in the
per-knot blocks ``zeta_k = [x_k; u_k]`` (the terminal knot's u slots are
padding held at zero by sigma).  H is factored once by a block-tridiagonal
Cholesky and reused every iteration, OSQP's factor-once / solve-many
design; the factorization and both substitution sweeps are loops over the
knots, as ops/riccati.py's sweep is.  The ADMM loop is the lane-batched
while loop of ``ops/while_loop.py``: each lane stops at its own exit.

Fixed penalty ``rho_admm`` (no adaptive rho: a new penalty would need a
new factorization).  Termination is OSQP's: eps_abs/eps_rel on the
infinity norms of the primal residual ``A z - b`` and the dual residual
``P z + g + A^T y``, each over one lane.

float32 blocks are solved in float64 and the result cast back, as
ops/riccati.py sweeps them: H's diagonal spans sigma = 1e-6 to
rho_admm * |A|^2 (1.7e8 on chip_smoke.py's N=64 Gauss-Newton blocks,
``qp_gates.py``), and in float32 the iteration diverges to NaN on every
lane.  (The TPU package runs ADMM in the inputs' dtype.)
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .kkt import QPBlocks
from .pcg import _mtv
from .riccati import _mv
from .while_loop import while_loop


class ADMMSolution(NamedTuple):
    X: torch.Tensor           # (*b, N, nx)
    U: torch.Tensor           # (*b, N-1, nu)
    y: torch.Tensor           # (*b, N, nx) constraint multipliers
    iterations: torch.Tensor  # (*b,) int32 ADMM iterations used
    r_prim: torch.Tensor      # (*b,) final ||A z - b||_inf
    r_dual: torch.Tensor      # (*b,) final ||P z + g + A' y||_inf
    # The interleaved primal iterate (*b, N, nx+nu): feed it back as
    # ``z0`` (with ``y`` as ``y0``) to warm-start the next related solve,
    # OSQP's object reuse.
    z: Optional[torch.Tensor] = None


def _inf_norm(v):
    """Per-lane infinity norm over the knot and variable axes."""
    return v.abs().amax((-2, -1))


def _blockdiag_P(blocks: QPBlocks, rho):
    """Per-knot P_k = blockdiag(Q_k, R_k + rho I) as (*b, N, nz, nz), and
    the gradient g (*b, N, nz).  ``rho``: a float or (*b,)."""
    A, B, c, Q, q, R, r = blocks
    nx, nu = Q.shape[-1], R.shape[-1]
    nz = nx + nu
    rho = torch.as_tensor(rho, dtype=Q.dtype, device=Q.device)[..., None, None, None]
    P = Q.new_zeros(Q.shape[:-2] + (nz, nz))
    P[..., :nx, :nx] = 0.5 * (Q + Q.mT)
    Reff = R + rho * torch.eye(nu, dtype=Q.dtype, device=Q.device)
    P[..., :-1, nx:, nx:] = 0.5 * (Reff + Reff.mT)
    g = q.new_zeros(q.shape[:-1] + (nz,))
    g[..., :nx] = q
    g[..., :-1, nx:] = r
    return P, g


def _constraint_apply(blocks: QPBlocks, z):
    """A z: row 0 = x_0; row k+1 = A_k x_k + B_k u_k - x_{k+1}."""
    nx = blocks.Q.shape[-1]
    x, u = z[..., :nx], z[..., :-1, nx:]
    dyn = _mv(blocks.A, x[..., :-1, :]) + _mv(blocks.B, u) - x[..., 1:, :]
    return torch.cat([x[..., :1, :], dyn], -2)


def _constraint_adjoint(blocks: QPBlocks, w):
    """A^T w for w (*b, N, nx), returned as (*b, N, nz)."""
    wd = w[..., 1:, :]                                       # (*b, N-1, nx)
    zero = torch.zeros_like(w[..., :1, :])
    ax = torch.cat([w[..., :1, :], -wd], -2) + torch.cat([_mtv(blocks.A, wd), zero], -2)
    au = torch.cat([_mtv(blocks.B, wd), torch.zeros_like(blocks.r[..., :1, :])], -2)
    return torch.cat([ax, au], -1)


def _build_H(blocks: QPBlocks, rho, sigma, rho_admm):
    """H = P + sigma I + rho_admm A^T A as block-tridiagonal (D, E).

    D: (*b, N, nz, nz) diagonal blocks; E: (*b, N-1, nz, nz) upper
    couplings ``H[k, k+1]``.
    """
    A, B = blocks.A, blocks.B
    nx = A.shape[-1]
    P, _ = _blockdiag_P(blocks, rho)
    nz = P.shape[-1]
    D = P + sigma * torch.eye(nz, dtype=P.dtype, device=P.device)

    # Selector diag(I_nx, 0): row 0 hits z_0, row k+1 hits z_{k+1}.
    D[..., :nx, :nx] += rho_admm * torch.eye(nx, dtype=P.dtype, device=P.device)

    # G_k = [A_k B_k]: D_k += rho G_k' G_k for k < N-1.
    G = torch.cat([A, B], -1)                                # (*b, N-1, nx, nz)
    D[..., :-1, :, :] += rho_admm * (G.mT @ G)

    # E_k = rho G_k' F, F = [-I 0]  =>  E_k = -rho [A_k B_k]' on x-columns.
    E = P.new_zeros(G.shape[:-2] + (nz, nz))
    E[..., :nx] = -rho_admm * G.mT
    return D, E


def _tri(L, b, transpose=False):
    """L^-1 b (or L^-T b) for lower-triangular L and vectors b."""
    if transpose:
        return torch.linalg.solve_triangular(L.mT, b[..., None], upper=True)[..., 0]
    return torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]


def _factor(D, E):
    """Block-tridiagonal Cholesky: H = L L^T, a loop over the knots.

    Returns (Ls (*b, N, nz, nz) lower-triangular diagonal factors,
    Ws (*b, N-1, nz, nz) with W_k = L_k^{-1} E_k, so L[k+1,k] = W_k^T).
    No status read: a block that is not positive definite gives wrong
    factors, not a host sync.
    """
    N = D.shape[-3]
    Ls, Ws = [], []
    S = D[..., 0, :, :]
    for k in range(N):
        L = torch.linalg.cholesky_ex(S)[0]
        Ls.append(L)
        if k < N - 1:
            W = torch.linalg.solve_triangular(L, E[..., k, :, :], upper=False)
            Ws.append(W)
            S = D[..., k + 1, :, :] - W.mT @ W
    return torch.stack(Ls, -3), torch.stack(Ws, -3)


def _solve_factored(Ls, Ws, rhs):
    """Solve H xi = rhs given the block Cholesky factors."""
    N = Ls.shape[-3]
    # Forward: v_0 = L_0^{-1} rhs_0; v_{k+1} = L_{k+1}^{-1}(rhs_{k+1} - W_k' v_k).
    v = [_tri(Ls[..., 0, :, :], rhs[..., 0, :])]
    for k in range(1, N):
        v.append(_tri(Ls[..., k, :, :], rhs[..., k, :] - _mtv(Ws[..., k - 1, :, :], v[-1])))
    # Backward: xi_{N-1} = L^{-T} v; xi_k = L_k^{-T}(v_k - W_k xi_{k+1}).
    x = [_tri(Ls[..., -1, :, :], v[-1], transpose=True)]
    for k in range(N - 2, -1, -1):
        x.append(_tri(Ls[..., k, :, :], v[k] - _mv(Ws[..., k, :, :], x[-1]), transpose=True))
    return torch.stack(x[::-1], -2)


def solve(
    blocks: QPBlocks,
    xs,
    rho,
    sigma: float = 1e-6,
    rho_admm: float = 1e3,
    alpha: float = 1.6,
    eps_abs: float = 1e-6,
    eps_rel: float = 1e-6,
    max_iters: int = 400,
    z0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
) -> ADMMSolution:
    """OSQP-algorithm ADMM solve of the block-tridiagonal QP, every lane at
    once.

    ``xs`` (*b, nx): pinned initial state (or the initial-state delta of
    the GN formulation); ``rho`` a float or (*b,).  ``z0`` (*b, N, nx+nu)
    and ``y0`` (*b, N, nx) warm-start the interleaved primal trajectory and
    the constraint multipliers (OSQP's warm-start surface).  float32 is
    solved in float64 (see the module docstring).
    """
    Q = blocks.Q
    if Q.dtype == torch.float32:
        up = lambda t: None if t is None else t.double()
        sol = solve(QPBlocks(*(b.double() for b in blocks)), xs.double(),
                    torch.as_tensor(rho).double(), sigma, rho_admm, alpha, eps_abs, eps_rel,
                    max_iters, up(z0), up(y0))
        return ADMMSolution(*(a.float() if a.is_floating_point() else a for a in sol))
    N, nx, nu = Q.shape[-3], Q.shape[-1], blocks.R.shape[-1]
    nz = nx + nu
    m_rows, n_vars = N * nx, N * nz

    P, g = _blockdiag_P(blocks, rho)
    Ls, Ws = _factor(*_build_H(blocks, rho, sigma, rho_admm))

    b = torch.cat([xs[..., None, :], -blocks.c], -2)         # (*b, N, nx)
    z = Q.new_zeros(Q.shape[:-2] + (nz,)) if z0 is None else z0
    y = torch.zeros_like(b) if y0 is None else y0

    Atb = _constraint_adjoint(blocks, rho_admm * b)
    b_inf, g_inf = _inf_norm(b), _inf_norm(g)

    def residuals(z, y):
        Az, Pz, Aty = _constraint_apply(blocks, z), _mv(P, z), _constraint_adjoint(blocks, y)
        return Az, Pz, Aty, _inf_norm(Az - b), _inf_norm(Pz + g + Aty)

    def cond(state):
        Az, Pz, Aty, rp, rd = residuals(*state)
        eps_p = eps_abs * math.sqrt(float(m_rows)) + eps_rel * torch.maximum(_inf_norm(Az), b_inf)
        eps_d = eps_abs * math.sqrt(float(n_vars)) + eps_rel * torch.maximum(
            torch.maximum(_inf_norm(Pz), _inf_norm(Aty)), g_inf)
        return ~((rp <= eps_p) & (rd <= eps_d))

    def body(state):
        z, y = state
        rhs = sigma * z - g + Atb - _constraint_adjoint(blocks, y)
        zt = _solve_factored(Ls, Ws, rhs)
        z_new = alpha * zt + (1.0 - alpha) * z
        y_new = y + rho_admm * alpha * (_constraint_apply(blocks, zt) - b)
        return z_new, y_new

    (z, y), iters = while_loop(cond, body, (z, y), max_iters)
    *_, rp, rd = residuals(z, y)
    return ADMMSolution(X=z[..., :nx], U=z[..., :-1, nx:], y=y, iterations=iters,
                        r_prim=rp, r_dual=rd, z=z)

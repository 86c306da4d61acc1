"""Horizon-parallel Riccati: the LQR backward pass as a parallel scan
(port of ``indy7_mpc_tpu/ops/riccati_pscan.py``).

The backward recursion is recast as an associative combination of
conditional value-function elements (Sarkka & Garcia-Fernandez, "Temporal
Parallelization of Dynamic Programming / LQT"), so the O(N) dependency
chain becomes ceil(log2 N) levels; in each level every knot combines at
once, a batch of small dense solves over lanes and knots.

Element semantics: a = (F, c, C, eta, J) represents the partially
minimized cost kernel between states x (entry) and z (exit)

    psi(x, z) = 0.5 (z - F x - c)' C^+ (z - F x - c)
                + 0.5 x' J x - eta' x     (+ const)

Combination (min over the shared intermediate state) is associative:

    F  = F2 (I + C1 J2)^-1 F1
    c  = F2 (I + C1 J2)^-1 (c1 + C1 eta2) + c2
    C  = F2 (I + C1 J2)^-1 C1 F2' + C2
    eta= F1' (I + J2 C1)^-1 (eta2 - J2 c1) + eta1
    J  = F1' (I + J2 C1)^-1 J2 F1 + J1

It solves the same QP as ops/riccati.py (rho on Quu), and follows its
dtype policy: :func:`solve_pscan` sweeps float32 blocks in float64.
"""
from __future__ import annotations

import torch

from ..dynamics.rnea import lu_solve
from .kkt import QPBlocks
from .riccati import RiccatiSolution, _mv, _sym, forward_pass


def _combine(a1, a2):
    """Associative combination of value-function elements (a1 earlier),
    batched over any leading dims."""
    F1, c1, C1, e1, J1 = a1
    F2, c2, C2, e2, J2 = a2
    eye = torch.eye(F1.shape[-1], dtype=F1.dtype, device=F1.device)

    # (I + C1 J2)^-1 applied from the left; shared for F, c, C.
    sol = lu_solve(eye + C1 @ J2, torch.cat([F1, (c1 + _mv(C1, e2))[..., None], C1], -1))
    nx = F1.shape[-1]
    Minv_F1, Minv_rhs, Minv_C1 = sol[..., :nx], sol[..., nx], sol[..., nx + 1:]

    F = F2 @ Minv_F1
    c = _mv(F2, Minv_rhs) + c2
    C = F2 @ Minv_C1 @ F2.mT + C2

    # (I + J2 C1)^-1 applied from the left; shared for eta, J.
    sol = lu_solve(eye + J2 @ C1, torch.cat([(e2 - _mv(J2, c1))[..., None], J2], -1))
    Mtinv_e, Mtinv_J2 = sol[..., 0], sol[..., 1:]

    eta = _mv(F1.mT, Mtinv_e) + e1
    J = F1.mT @ Mtinv_J2 @ F1 + J1
    return (F, c, C, eta, _sym(J))


_IS_MATRIX = (True, False, True, False, True)  # F, c, C, eta, J


def _knots(elems, sl):
    """The knots ``sl`` of every element field (matrices carry the knot
    axis at -3, vectors at -2)."""
    return tuple(e[..., sl, :, :] if m else e[..., sl, :] for e, m in zip(elems, _IS_MATRIX))


def _reverse_scan(elems):
    """Suffix scan: element k becomes ``e_k * e_{k+1} * ... * e_{N-1}``
    under :func:`_combine`, in ceil(log2 N) levels (Hillis-Steele), for
    any N."""
    N = elems[0].shape[-3]
    d = 1
    while d < N:
        head = _combine(_knots(elems, slice(None, N - d)), _knots(elems, slice(d, None)))
        elems = tuple(torch.cat([h, t], -3 if m else -2) for h, t, m in
                      zip(head, _knots(elems, slice(N - d, None)), _IS_MATRIX))
        d *= 2
    return elems


def backward_pscan(blocks: QPBlocks, rho):
    """Cost-to-go (S_k, s_k) for every knot via one parallel scan.

    Returns (S, s) with shapes (*b, N, nx, nx), (*b, N, nx):
    V_k(x) = 0.5 x' S_k x + s_k' x (+ const).  ``rho``: a float or (*b,).
    """
    A, B, c, Q, q, R, r = blocks
    nu = B.shape[-1]
    rho = torch.as_tensor(rho, dtype=A.dtype, device=A.device)[..., None, None, None]

    # Fold rho into the control cost: matches riccati.py's Quu + rho I.
    Rr = _sym(R) + rho * torch.eye(nu, dtype=A.dtype, device=A.device)
    Rc = torch.linalg.cholesky_ex(Rr)[0]
    Rinv_Bt = torch.cholesky_solve(B.mT, Rc)               # R^-1 B'
    Rinv_r = torch.cholesky_solve(r[..., None], Rc)[..., 0]

    # Step elements k = 0..N-2, then the terminal element.
    zmat = torch.zeros_like(A[..., :1, :, :])
    zvec = torch.zeros_like(c[..., :1, :])
    elems = (
        torch.cat([A, zmat], -3),
        torch.cat([c - _mv(B, Rinv_r), zvec], -2),
        torch.cat([B @ Rinv_Bt, zmat], -3),
        -q,
        _sym(Q),
    )
    _, _, _, eta, J = _reverse_scan(elems)
    return J, -eta


def solve_pscan(blocks: QPBlocks, xs, rho) -> RiccatiSolution:
    """Exact block-tridiagonal QP solve, horizon-parallel backward pass.

    Same problem and rho semantics as :func:`riccati.solve`, float32
    swept in float64 as there; the forward rollout recomputes the
    per-knot gains from the scanned cost-to-go.
    """
    dtype = blocks.A.dtype
    if dtype == torch.float32:
        sol = solve_pscan(QPBlocks(*(b.double() for b in blocks)), xs.double(),
                          torch.as_tensor(rho).double())
        return RiccatiSolution(*(a.to(dtype) for a in sol))
    A, B, c, Q, q, R, r = blocks
    nu = B.shape[-1]
    rho_t = torch.as_tensor(rho, dtype=dtype, device=A.device)[..., None, None, None]
    S, s = backward_pscan(blocks, rho)
    S1, s1 = S[..., 1:, :, :], s[..., 1:, :]

    # Gains at every knot at once.
    Sc = s1 + _mv(S1, c)
    BtS = B.mT @ S1
    Quu = _sym(R + BtS @ B) + rho_t * torch.eye(nu, dtype=dtype, device=A.device)
    L = torch.linalg.cholesky_ex(Quu)[0]
    sol = torch.cholesky_solve(torch.cat([BtS @ A, (r + _mv(B.mT, Sc))[..., None]], -1), L)
    K, kff = -sol[..., :-1], -sol[..., -1]

    X, U = forward_pass(blocks, K, kff, xs)
    return RiccatiSolution(X=X, U=U, K=K, kff=kff)

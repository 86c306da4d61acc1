"""Dense KKT solver for the equality-constrained trajectory QP (numpy;
port of ``ops/dense_kkt.py``).

The transparent CPU oracle, playing the role OSQP plays for the
reference: an exact, readable solve of

    min 0.5 z^T P z + g^T z   s.t.  x_0 = xs,
        x_{k+1} = A_k x_k + B_k u_k + c_k

by factorizing the full [P G^T; G 0] system, for one lane.  Used by the
tests to validate the Riccati sweep; also usable directly for small
problems.  Tensors on any device are read through the host.
"""
from __future__ import annotations

import numpy as np

from .kkt import QPBlocks


def _np(a):
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def solve(blocks: QPBlocks, xs, rho: float = 0.0):
    """Exact dense solve; returns (X (N, nx), U (N-1, nu)) as float64."""
    A, B, c, Q, q, R, r = (_np(b) for b in blocks)
    xs = _np(xs)
    N, nx = Q.shape[0], Q.shape[2]
    nu = B.shape[2]
    nz = N * nx + (N - 1) * nu

    def xi(k):
        return slice(k * (nx + nu), k * (nx + nu) + nx)

    def ui(k):
        return slice(k * (nx + nu) + nx, (k + 1) * (nx + nu))

    P = np.zeros((nz, nz))
    g = np.zeros(nz)
    for k in range(N):
        P[xi(k), xi(k)] = Q[k]
        g[xi(k)] = q[k]
    for k in range(N - 1):
        P[ui(k), ui(k)] = R[k] + rho * np.eye(nu)
        g[ui(k)] = r[k]

    nc = N * nx
    G = np.zeros((nc, nz))
    h = np.zeros(nc)
    G[:nx, xi(0)] = np.eye(nx)
    h[:nx] = xs
    for k in range(N - 1):
        rows = slice((k + 1) * nx, (k + 2) * nx)
        G[rows, xi(k)] = A[k]
        G[rows, ui(k)] = B[k]
        G[rows, xi(k + 1)] = -np.eye(nx)
        h[rows] = -c[k]

    KKT = np.block([[P, G.T], [G, np.zeros((nc, nc))]])
    sol = np.linalg.solve(KKT, np.concatenate([-g, h]))
    z = sol[:nz]
    X = np.stack([z[xi(k)] for k in range(N)])
    U = np.stack([z[ui(k)] for k in range(N - 1)])
    return X, U

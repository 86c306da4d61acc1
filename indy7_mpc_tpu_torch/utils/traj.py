"""Trajectory layout utilities (port of ``utils/traj.py``).

The native layout is structured: ``X (N, nx)``, ``U (N-1, nu)``.  The
reference uses a flat interleaved vector ``[x0, u0, x1, u1, ..., xN-1]``
of length ``N*(nx+nu) - nu``; these converters give parity with recorded
data and tests.
"""
from __future__ import annotations

import torch


def pack_xu(X, U):
    """(N, nx), (N-1, nu) -> flat interleaved (N*(nx+nu) - nu,)."""
    N, nx = X.shape[-2], X.shape[-1]
    nu = U.shape[-1]
    body = torch.cat([X[..., :-1, :], U], dim=-1).reshape(
        *X.shape[:-2], (N - 1) * (nx + nu)
    )
    return torch.cat([body, X[..., -1, :]], dim=-1)


def unpack_xu(xu, N, nx, nu):
    """Flat interleaved -> ``(X (N, nx), U (N-1, nu))``."""
    body = xu[..., : (N - 1) * (nx + nu)].reshape(*xu.shape[:-1], N - 1, nx + nu)
    X = torch.cat([body[..., :nx], xu[..., None, (N - 1) * (nx + nu):]], dim=-2)
    return X, body[..., nx:]


def goals_from_flat(goals_flat, N):
    """Reference 6-per-knot goal vector -> (N, 3) positions.

    The reference appends three zero entries per knot; only xyz is used by
    the cost.
    """
    return goals_flat[..., : 6 * N].reshape(*goals_flat.shape[:-1], N, 6)[..., :3]

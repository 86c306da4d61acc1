"""Spatial (6D) rigid-body algebra on tensors (port of ``models/spatial.py``).

Conventions
-----------
* Linear-first 6-vectors, matching Pinocchio's layout:
    motion  m = (v, w)   -- linear velocity at the frame origin, angular velocity
    force   f = (f, n)   -- linear force, moment about the frame origin
* A frame placement ``X = (R, p)`` maps local coordinates to parent
  coordinates: ``x_parent = R @ x_local + p``.
* All functions broadcast over arbitrary leading batch dimensions: a
  3-vector has shape ``(*batch, 3)`` and a rotation ``(*batch, 3, 3)``.

Every function is functional (no in-place writes), so ``torch.func``
transforms and forward-mode autodiff pass through it.
"""
from __future__ import annotations

import torch


def cross(a, b):
    """Batched 3D cross product, shapes (*batch, 3)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def hat(v):
    """Skew-symmetric matrix [v]_x with shape (*batch, 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    rows = [
        torch.stack([z, -vz, vy], dim=-1),
        torch.stack([vz, z, -vx], dim=-1),
        torch.stack([-vy, vx, z], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rotz(q):
    """Rotation about z by angle q; q shape (*batch,), result (*batch, 3, 3)."""
    c, s = torch.cos(q), torch.sin(q)
    z = torch.zeros_like(q)
    o = torch.ones_like(q)
    rows = [
        torch.stack([c, -s, z], dim=-1),
        torch.stack([s, c, z], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rot_axis(axis, q):
    """Rodrigues rotation about a fixed unit ``axis`` (3,) by angle q (*batch,)."""
    c, s = torch.cos(q), torch.sin(q)
    K = hat(torch.as_tensor(axis, dtype=q.dtype, device=q.device))
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return (
        eye
        + s[..., None, None] * K
        + (1.0 - c)[..., None, None] * (K @ K)
    )


def rpy_matrix(r, p, y):
    """URDF fixed-axis roll-pitch-yaw to rotation matrix: R = Rz(y) Ry(p) Rx(r).

    ``r, p, y`` are 0-d tensors (or floats, which give float64)."""
    r, p, y = (torch.as_tensor(a, dtype=torch.float64) if not torch.is_tensor(a)
               else a for a in (r, p, y))
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    rows = [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ]
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def mv(R, x):
    """Batched matrix-vector product: (*b, 3, 3) @ (*b, 3) -> (*b, 3)."""
    return torch.einsum("...ij,...j->...i", R, x)


def mtv(R, x):
    """Batched R^T @ x."""
    return torch.einsum("...ji,...j->...i", R, x)


# ---------------------------------------------------------------------------
# Spatial motion / force transforms between frames.
#
# X = (R, p): pose of frame B in frame A coordinates (x_A = R x_B + p).
# ---------------------------------------------------------------------------

def motion_to_child(R, p, v, w):
    """Express a spatial motion (v, w at A's origin in A axes) in frame B."""
    w_b = mtv(R, w)
    v_b = mtv(R, v + cross(w, p))
    return v_b, w_b


def motion_to_parent(R, p, v, w):
    """Express a spatial motion given in frame B at A's origin in A axes."""
    w_a = mv(R, w)
    v_a = mv(R, v) + cross(p, w_a)
    return v_a, w_a


def force_to_parent(R, p, f, n):
    """Express a spatial force (f, n about B's origin in B axes) in frame A."""
    f_a = mv(R, f)
    n_a = mv(R, n) + cross(p, f_a)
    return f_a, n_a


def force_to_child(R, p, f, n):
    """Express a spatial force (f, n about A's origin in A axes) in frame B.

    This is the transform the reference applies to map a world-frame wrench
    onto the end-effector joint frame (``oMi[6].actInv``).
    """
    f_b = mtv(R, f)
    n_b = mtv(R, n - cross(p, f))
    return f_b, n_b


def cross_motion(v1, w1, v2, w2):
    """Spatial cross product of motions: (v1,w1) x (v2,w2)."""
    return cross(w1, v2) + cross(v1, w2), cross(w1, w2)


def cross_force(v, w, f, n):
    """Spatial cross product motion x* force (appears in Coriolis terms)."""
    return cross(w, f), cross(w, n) + cross(v, f)


def inertia_mul(m, h, I_o, v, w):
    """Apply a spatial inertia to a motion, all about the same frame origin.

    m: mass (*b,), h: first moment m*com (*b, 3),
    I_o: rotational inertia about the frame origin (*b, 3, 3).
    Returns the spatial momentum (p_lin, L) = (m v - h x w, I_o w + h x v).
    """
    p_lin = m[..., None] * v - cross(h, w)
    L = mv(I_o, w) + cross(h, v)
    return p_lin, L


def inertia_about_origin(mass, com, I_com):
    """Shift a rotational inertia from the COM to the frame origin.

    I_o = I_c + m * (c.c I - c c^T)  (parallel axis theorem).
    """
    c = com
    cc = torch.einsum("...i,...i->...", c, c)
    outer = torch.einsum("...i,...j->...ij", c, c)
    eye = torch.eye(3, dtype=I_com.dtype, device=I_com.device)
    return I_com + mass[..., None, None] * (cc[..., None, None] * eye - outer)

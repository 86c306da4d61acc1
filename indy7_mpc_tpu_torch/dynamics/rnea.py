"""Rigid-body dynamics: RNEA, CRBA and forward dynamics (port of
``dynamics/rnea.py``).

Replaces the reference's Pinocchio calls:
  * ``pin.aba(model, data, q, v, u[, f_ext])`` -> :func:`forward_dynamics`
    (a mass-matrix solve; the same continuous dynamics);
  * the external wrench's ``oMi[6].actInv(world_force)`` ->
    :func:`world_wrench_to_ee_joint`.

Spatial quantities are linear-first: motion = (v, w), force = (f, n).
Recursions run in local joint frames (Featherstone RBDA Table 5.1) with the
gravity-as-base-acceleration trick.  The joint loops are Python loops;
everything broadcasts over leading batch dims and runs on the inputs'
device.  The code is functional (no in-place writes, no host reads), so
``torch.func.jvp`` differentiates through it (ops/kkt.py).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import spatial
from ..models.robot import RobotModel
from .kinematics import joint_frames


def _link_inertia(model: RobotModel, i):
    """(mass, first moment h = m c, inertia about joint origin) of link i."""
    m = model.mass[i]
    h = m * model.com[i]
    I_o = spatial.inertia_about_origin(
        model.mass[i][None], model.com[i][None], model.I_com[i][None]
    )[0]
    return m, h, I_o


def _local_placement(model: RobotModel, i, q):
    """Parent -> joint ``i`` placement (R, p) at joint angle ``q[..., i]``."""
    R = model.tree_R[i] @ spatial.rot_axis(model.axis[i], q[..., i])
    return R, model.tree_p[i]


def rnea(
    model: RobotModel,
    q,
    v,
    a,
    f_ext: Optional[torch.Tensor] = None,
    gravity: bool = True,
):
    """Inverse dynamics: joint torques realizing acceleration ``a``.

    Args:
      q, v, a: ``(*batch, nj)`` joint position / velocity / acceleration.
      f_ext: optional ``(*batch, nj, 6)`` external spatial forces (f, n)
        applied to each link, expressed in that link's joint frame.
      gravity: include gravity (model.gravity) if True.

    Returns ``tau`` with shape ``(*batch, nj)``.
    """
    nj = model.nj
    batch = q.shape[:-1]
    zero3 = torch.zeros(batch + (3,), dtype=q.dtype, device=q.device)
    a0_lin = torch.broadcast_to(-model.gravity, batch + (3,)) if gravity else zero3

    f_lin, f_ang = [], []
    Rs, ps = [], []  # local placements, cached for the backward pass
    vp_lin, vp_ang = zero3, zero3
    ap_lin, ap_ang = a0_lin, zero3
    for i in range(nj):
        R_li, p_li = _local_placement(model, i, q)
        Rs.append(R_li)
        ps.append(p_li)
        axis = model.axis[i]
        qd = v[..., i][..., None]
        qdd = a[..., i][..., None]

        vi_lin, vi_ang = spatial.motion_to_child(R_li, p_li, vp_lin, vp_ang)
        vJ_ang = axis * qd
        vi_ang = vi_ang + vJ_ang

        ai_lin, ai_ang = spatial.motion_to_child(R_li, p_li, ap_lin, ap_ang)
        # a += S qdd + v x vJ   (vJ = (0, axis qd))
        cx_lin, cx_ang = spatial.cross_motion(vi_lin, vi_ang, 0.0 * vi_lin, vJ_ang)
        ai_ang = ai_ang + axis * qdd + cx_ang
        ai_lin = ai_lin + cx_lin

        m, h, I_o = _link_inertia(model, i)
        Iv_lin, Iv_ang = spatial.inertia_mul(m, h, I_o, vi_lin, vi_ang)
        Ia_lin, Ia_ang = spatial.inertia_mul(m, h, I_o, ai_lin, ai_ang)
        vx_lin, vx_ang = spatial.cross_force(vi_lin, vi_ang, Iv_lin, Iv_ang)
        fi_lin = Ia_lin + vx_lin
        fi_ang = Ia_ang + vx_ang
        if f_ext is not None:
            fi_lin = fi_lin - f_ext[..., i, :3]
            fi_ang = fi_ang - f_ext[..., i, 3:]
        f_lin.append(fi_lin)
        f_ang.append(fi_ang)
        vp_lin, vp_ang = vi_lin, vi_ang
        ap_lin, ap_ang = ai_lin, ai_ang

    tau = [None] * nj
    for i in range(nj - 1, -1, -1):
        tau[i] = torch.einsum("...i,i->...", f_ang[i], model.axis[i])
        if i > 0:
            fp_lin, fp_ang = spatial.force_to_parent(Rs[i], ps[i], f_lin[i], f_ang[i])
            f_lin[i - 1] = f_lin[i - 1] + fp_lin
            f_ang[i - 1] = f_ang[i - 1] + fp_ang
    return torch.stack(tau, dim=-1)


def _shift(mass, c, I, sign):
    """Add (sign=+1) or remove (sign=-1) the parallel-axis term."""
    eye = torch.eye(3, dtype=I.dtype, device=I.device)
    return I + sign * mass[..., None, None] * (
        torch.einsum("...i,...i->...", c, c)[..., None, None] * eye
        - torch.einsum("...i,...j->...ij", c, c)
    )


def _inertia_to_parent(R, p, m, h, I_o):
    """Shift a spatial inertia (about frame B origin) into frame A, X=(R,p).

    ``m``: (*b,), ``h``: (*b, 3), ``I_o``: (*b, 3, 3).
    """
    c = h / m[..., None]
    c_new = spatial.mv(R, c) + p
    I_c = _shift(m, c, I_o, -1.0)
    I_c_new = R @ I_c @ R.transpose(-1, -2)
    I_o_new = _shift(m, c_new, I_c_new, 1.0)
    return m, m[..., None] * c_new, I_o_new


def crba(model: RobotModel, q) -> torch.Tensor:
    """Joint-space mass matrix via the composite-rigid-body algorithm.

    Returns ``M`` with shape ``(*batch, nj, nj)`` (symmetric, PD).
    """
    nj = model.nj
    batch = q.shape[:-1]
    placements = [_local_placement(model, i, q) for i in range(nj)]

    # Composite inertias, leaves -> root.
    comp = []
    for i in range(nj):
        m, h, I_o = _link_inertia(model, i)
        comp.append([
            torch.broadcast_to(m, batch),
            torch.broadcast_to(h, batch + (3,)),
            torch.broadcast_to(I_o, batch + (3, 3)),
        ])
    for i in range(nj - 1, 0, -1):
        m, h, I_o = _inertia_to_parent(*placements[i], *comp[i])
        comp[i - 1] = [comp[i - 1][0] + m, comp[i - 1][1] + h, comp[i - 1][2] + I_o]

    M = [[None] * nj for _ in range(nj)]
    for i in range(nj):
        _, hi, Ii = comp[i]
        axis_b = torch.broadcast_to(model.axis[i], batch + (3,))
        # F = I^c S,  S = (0, axis): force = (-h x axis, I_o axis)
        F_lin = -spatial.cross(hi, axis_b)
        F_ang = spatial.mv(Ii, axis_b)
        M[i][i] = torch.einsum("...k,k->...", F_ang, model.axis[i])
        for j in range(i, 0, -1):
            F_lin, F_ang = spatial.force_to_parent(*placements[j], F_lin, F_ang)
            M[i][j - 1] = torch.einsum("...k,k->...", F_ang, model.axis[j - 1])
            M[j - 1][i] = M[i][j - 1]
    return torch.stack([torch.stack(row, dim=-1) for row in M], dim=-2)


def world_wrench_to_ee_joint(model: RobotModel, q, wrench_world):
    """Map a world-frame wrench onto the EE joint's local frame.

    ``wrench_world = (fx, fy, fz, nx, ny, nz)`` is a spatial force expressed
    in the world frame (moment about the world origin), the semantics of
    ``data.oMi[6].actInv(pin.Force(f, n))`` in the reference.  Returns a
    ``(*batch, 6)`` local spatial force to feed :func:`forward_dynamics`.
    """
    R, p = joint_frames(model, q)
    f_l, n_l = spatial.force_to_child(
        R[..., -1, :, :], p[..., -1, :], wrench_world[..., :3], wrench_world[..., 3:]
    )
    return torch.cat([f_l, n_l], dim=-1)


def _ee_f_ext(model: RobotModel, batch, f_ext_ee):
    """Expand an EE-only local wrench to the per-joint (nj, 6) layout."""
    f_ee = torch.broadcast_to(f_ext_ee, batch + (6,))
    zeros = torch.zeros(batch + (model.nj - 1, 6), dtype=f_ee.dtype, device=f_ee.device)
    return torch.cat([zeros, f_ee[..., None, :]], dim=-2)


def bias_forces(model: RobotModel, q, v, f_ext_ee=None, gravity: bool = True):
    """C(q, v) v + g(q) - J^T f_ext: RNEA at zero acceleration."""
    f_ext = None
    if f_ext_ee is not None:
        f_ext = _ee_f_ext(model, q.shape[:-1], f_ext_ee)
    return rnea(model, q, v, torch.zeros_like(q), f_ext=f_ext, gravity=gravity)


def forward_dynamics(
    model: RobotModel, q, v, tau, f_ext_ee=None, gravity: bool = True
) -> torch.Tensor:
    """Joint accelerations: ``a = M(q)^-1 (tau - bias(q, v, f_ext))``.

    The same continuous model as the reference's ``pin.aba``, computed as
    the CRBA followed by a pivoted-LU solve (:func:`lu_solve`).

    ``f_ext_ee``: optional ``(*batch, 6)`` spatial force on the last link in
    its local joint frame (use :func:`world_wrench_to_ee_joint` to build it
    from a world wrench).
    """
    b = bias_forces(model, q, v, f_ext_ee=f_ext_ee, gravity=gravity)
    M = crba(model, q)
    return lu_solve(M, (tau - b)[..., None])[..., 0]


def lu_solve(A, B):
    """``torch.linalg.solve`` (pivoted LU) without its error check, which
    reads the factorization's status on the host: a singular system gives
    non-finite values, as ``jnp.linalg.solve`` does, and no sync."""
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]

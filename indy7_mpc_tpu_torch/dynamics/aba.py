"""Articulated-body algorithm (ABA): O(n) forward dynamics (port of
``dynamics/aba.py``).

The same continuous dynamics as :func:`.rnea.forward_dynamics` (the
CRBA-and-solve default), computed by Featherstone's articulated-body
recursion instead of an explicit mass-matrix solve; a cross-check of it,
as the reference's ``pin.aba`` is.

Conventions follow models/spatial.py: linear-first 6-vectors, local
joint-frame recursions, gravity as a base acceleration.  Articulated
inertias are full symmetric 6x6 matrices in the (linear, angular) block
layout; all products broadcast over leading batch dims.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import spatial
from ..models.robot import RobotModel
from .rnea import _ee_f_ext, _link_inertia, _local_placement


def _inertia6(m, h, I_o, batch):
    """Dense 6x6 spatial inertia [[m I, -hx], [hx, I_o]] (linear-first)."""
    hx = spatial.hat(torch.broadcast_to(h, batch + (3,)))
    mI = m * torch.eye(3, dtype=h.dtype, device=h.device)
    top = torch.cat([torch.broadcast_to(mI, batch + (3, 3)), -hx], dim=-1)
    bot = torch.cat([hx, torch.broadcast_to(I_o, batch + (3, 3))], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _ia_to_parent(R, p, IA):
    """Transform an articulated inertia from child frame B to parent A.

    I_A = F I_B X  with the force map F = [[R, 0], [px R, R]] and the
    motion map (parent -> child) X = [[R^T, -R^T px], [0, R^T]].
    """
    batch = IA.shape[:-2]
    z3 = torch.zeros(batch + (3, 3), dtype=IA.dtype, device=IA.device)
    Rb = torch.broadcast_to(R, batch + (3, 3))
    px = spatial.hat(torch.broadcast_to(p, batch + (3,)))
    F = torch.cat(
        [torch.cat([Rb, z3], dim=-1), torch.cat([px @ Rb, Rb], dim=-1)], dim=-2
    )
    Rt = Rb.transpose(-1, -2)
    X = torch.cat(
        [torch.cat([Rt, -Rt @ px], dim=-1), torch.cat([z3, Rt], dim=-1)], dim=-2
    )
    return F @ IA @ X


def aba(
    model: RobotModel,
    q,
    v,
    tau,
    f_ext: Optional[torch.Tensor] = None,
    gravity: bool = True,
):
    """Forward dynamics by the articulated-body algorithm.

    Args:
      q, v, tau: ``(*batch, nj)`` position / velocity / torque.
      f_ext: optional ``(*batch, nj, 6)`` local spatial forces (f, n) per
        link (same layout as :func:`.rnea.rnea`).
      gravity: include model.gravity if True.

    Returns joint accelerations ``(*batch, nj)``.
    """
    nj = model.nj
    batch = q.shape[:-1]
    dtype, device = q.dtype, q.device
    zero3 = torch.zeros(batch + (3,), dtype=dtype, device=device)

    # --- Pass 1: velocities, bias accelerations, leaf inertias/forces.
    Rs, ps = [], []
    c_lin, c_ang = [], []
    IA, pA_lin, pA_ang = [], [], []
    vp_lin, vp_ang = zero3, zero3
    for i in range(nj):
        R_li, p_li = _local_placement(model, i, q)
        Rs.append(R_li)
        ps.append(p_li)
        vi_lin, vi_ang = spatial.motion_to_child(R_li, p_li, vp_lin, vp_ang)
        vJ_ang = model.axis[i] * v[..., i][..., None]
        vi_ang = vi_ang + vJ_ang
        # c = v x vJ, vJ = (0, axis qd)
        ci_lin, ci_ang = spatial.cross_motion(vi_lin, vi_ang, 0.0 * vi_lin, vJ_ang)

        m, h, I_o = _link_inertia(model, i)
        Iv_lin, Iv_ang = spatial.inertia_mul(m, h, I_o, vi_lin, vi_ang)
        bi_lin, bi_ang = spatial.cross_force(vi_lin, vi_ang, Iv_lin, Iv_ang)
        if f_ext is not None:
            bi_lin = bi_lin - f_ext[..., i, :3]
            bi_ang = bi_ang - f_ext[..., i, 3:]
        c_lin.append(ci_lin)
        c_ang.append(ci_ang)
        IA.append(_inertia6(m, h, I_o, batch))
        pA_lin.append(bi_lin)
        pA_ang.append(bi_ang)
        vp_lin, vp_ang = vi_lin, vi_ang

    # --- Pass 2: articulated inertias, leaves -> root.
    s6 = [torch.cat([torch.zeros_like(model.axis[i]), model.axis[i]]) for i in range(nj)]
    U, d, u = [None] * nj, [None] * nj, [None] * nj
    for i in range(nj - 1, -1, -1):
        U[i] = torch.einsum("...ij,j->...i", IA[i], s6[i])
        d[i] = torch.einsum("...i,i->...", U[i], s6[i])
        pA6 = torch.cat([pA_lin[i], pA_ang[i]], dim=-1)
        u[i] = tau[..., i] - torch.einsum("...i,i->...", pA6, s6[i])
        if i > 0:
            Ia = IA[i] - torch.einsum("...i,...j->...ij", U[i], U[i]) / d[i][..., None, None]
            c6 = torch.cat([c_lin[i], c_ang[i]], dim=-1)
            pa6 = (
                pA6
                + torch.einsum("...ij,...j->...i", Ia, c6)
                + U[i] * (u[i] / d[i])[..., None]
            )
            IA[i - 1] = IA[i - 1] + _ia_to_parent(Rs[i], ps[i], Ia)
            fp_lin, fp_ang = spatial.force_to_parent(Rs[i], ps[i], pa6[..., :3], pa6[..., 3:])
            pA_lin[i - 1] = pA_lin[i - 1] + fp_lin
            pA_ang[i - 1] = pA_ang[i - 1] + fp_ang

    # --- Pass 3: accelerations, root -> leaves.
    ap_lin = torch.broadcast_to(-model.gravity, batch + (3,)) if gravity else zero3
    ap_ang = zero3
    qdd = [None] * nj
    for i in range(nj):
        ai_lin, ai_ang = spatial.motion_to_child(Rs[i], ps[i], ap_lin, ap_ang)
        ai_lin = ai_lin + c_lin[i]
        ai_ang = ai_ang + c_ang[i]
        a6 = torch.cat([ai_lin, ai_ang], dim=-1)
        qdd[i] = (u[i] - torch.einsum("...i,...i->...", U[i], a6)) / d[i]
        ai_ang = ai_ang + model.axis[i] * qdd[i][..., None]
        ap_lin, ap_ang = ai_lin, ai_ang
    return torch.stack(qdd, dim=-1)


def forward_dynamics_aba(
    model: RobotModel, q, v, tau, f_ext_ee=None, gravity: bool = True
):
    """Drop-in for :func:`.rnea.forward_dynamics` using the ABA recursion.

    ``f_ext_ee``: optional ``(*batch, 6)`` local spatial force on the last
    link (see :func:`.rnea.world_wrench_to_ee_joint`).
    """
    f_ext = None
    if f_ext_ee is not None:
        f_ext = _ee_f_ext(model, q.shape[:-1], f_ext_ee)
    return aba(model, q, v, tau, f_ext=f_ext, gravity=gravity)

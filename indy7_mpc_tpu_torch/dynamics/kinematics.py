"""Forward kinematics and end-effector Jacobians (port of
``dynamics/kinematics.py``).

Replaces the reference's Pinocchio calls:
  * ``pin.forwardKinematics`` + ``data.oMi[6].translation`` -> :func:`ee_pos`
  * ``pin.getJointJacobian(..., LOCAL_WORLD_ALIGNED)[:3, :]`` ->
    :func:`ee_pos_jacobian`

All functions broadcast over arbitrary leading batch dims of ``q`` and run
on ``q``'s device; the model must be on the same device.  The "end
effector" is the last joint frame's origin (Pinocchio joint id 6); the
tool-center-point adds the fixed ``tcp_offset``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models import spatial
from ..models.robot import RobotModel


def joint_frames(model: RobotModel, q) -> Tuple[torch.Tensor, torch.Tensor]:
    """World placements of every joint frame.

    Returns ``(R, p)`` with shapes ``(*batch, nj, 3, 3)`` and
    ``(*batch, nj, 3)``; frame ``i`` includes the rotation by ``q_i``.
    """
    Rs, ps = [], []
    R_w = p_w = None
    for i in range(model.nj):
        R_li = model.tree_R[i] @ spatial.rot_axis(model.axis[i], q[..., i])
        if i == 0:
            R_w = R_li
            p_w = torch.broadcast_to(model.tree_p[i], q[..., 0].shape + (3,))
        else:
            p_w = p_w + spatial.mv(R_w, model.tree_p[i])
            R_w = R_w @ R_li
        Rs.append(R_w)
        ps.append(p_w)
    return torch.stack(Rs, dim=-3), torch.stack(ps, dim=-2)


def ee_pos(model: RobotModel, q) -> torch.Tensor:
    """Position of the last joint frame origin, shape ``(*batch, 3)``."""
    _, p = joint_frames(model, q)
    return p[..., -1, :]


def tcp_pos(model: RobotModel, q) -> torch.Tensor:
    """Tool-center-point position (last joint frame + fixed tcp offset)."""
    R, p = joint_frames(model, q)
    return p[..., -1, :] + spatial.mv(R[..., -1, :, :], model.tcp_offset)


def ee_pos_jacobian(model: RobotModel, q) -> Tuple[torch.Tensor, torch.Tensor]:
    """EE position and its 3 x nj world-aligned Jacobian.

    Column ``i`` is ``axis_i^w x (p_ee - p_i)`` for a revolute joint, the
    linear block of the LOCAL_WORLD_ALIGNED joint Jacobian at the EE joint.
    Returns ``(eepos (*b, 3), J (*b, 3, nj))``.
    """
    R, p = joint_frames(model, q)
    p_ee = p[..., -1, :]
    cols = []
    for i in range(model.nj):
        axis_w = spatial.mv(R[..., i, :, :], model.axis[i])
        cols.append(spatial.cross(axis_w, p_ee - p[..., i, :]))
    return p_ee, torch.stack(cols, dim=-1)

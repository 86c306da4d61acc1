"""Robot model: a fixed-topology serial chain as a frozen dataclass of tensors.

Port of ``indy7_mpc_tpu/models/robot.py``.  The Indy7 parameters are the
same physical robot data (transcribed from the reference URDF), copied here
as plain data so that this package needs no JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

FIELDS = (
    "tree_R", "tree_p", "axis", "mass", "com", "I_com", "tcp_offset",
    "gravity", "effort_limit", "velocity_limit", "q_lower", "q_upper",
)


@dataclasses.dataclass(frozen=True, eq=False)
class RobotModel:
    """Serial-chain rigid-body model (fixed base, revolute joints).

    Link ``i`` is the child body of joint ``i``; its inertial parameters
    are expressed in joint ``i``'s frame.
    """

    tree_R: torch.Tensor  # (nj, 3, 3) joint frame in parent frame at q = 0
    tree_p: torch.Tensor  # (nj, 3)
    axis: torch.Tensor    # (nj, 3) joint rotation axis in the joint frame
    mass: torch.Tensor    # (nj,)
    com: torch.Tensor     # (nj, 3)
    I_com: torch.Tensor   # (nj, 3, 3) rotational inertia about the COM
    tcp_offset: torch.Tensor  # (3,)
    gravity: torch.Tensor     # (3,) linear gravity in the world frame
    effort_limit: torch.Tensor    # (nj,)
    velocity_limit: torch.Tensor  # (nj,)
    q_lower: torch.Tensor  # (nj,)
    q_upper: torch.Tensor  # (nj,)

    @property
    def nj(self) -> int:
        return self.tree_p.shape[0]

    nq = nv = nu = nj

    @property
    def nx(self) -> int:
        return 2 * self.nj

    def to(self, device=None, dtype=None) -> "RobotModel":
        return RobotModel(
            **{f: getattr(self, f).to(device=device, dtype=dtype) for f in FIELDS}
        )


def rpy_matrix(r: float, p: float, y: float) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw: R = Rz(y) Ry(p) Rx(r) (float64)."""
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def _make_model(params: dict, dtype, device) -> RobotModel:
    joints = params["joints"]
    nj = len(joints)
    arrays = {
        "tree_R": np.stack([rpy_matrix(*j["rpy"]) for j in joints]),
        "tree_p": np.array([j["xyz"] for j in joints], np.float64),
        "axis": np.array([j["axis"] for j in joints], np.float64),
        "mass": np.array([j["mass"] for j in joints], np.float64),
        "com": np.array([j["com"] for j in joints], np.float64),
        "I_com": np.zeros((nj, 3, 3)),
        "tcp_offset": np.array(params["tcp_offset"], np.float64),
        "gravity": np.array(params.get("gravity", [0.0, 0.0, -9.81])),
        "effort_limit": np.array([j["effort"] for j in joints], np.float64),
        "velocity_limit": np.array([j["velocity"] for j in joints]),
        "q_lower": np.array([j["lower"] for j in joints], np.float64),
        "q_upper": np.array([j["upper"] for j in joints], np.float64),
    }
    for i, j in enumerate(joints):
        ixx, ixy, ixz, iyy, iyz, izz = j["inertia"]
        arrays["I_com"][i] = [[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]]
    return RobotModel(
        **{
            k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in arrays.items()
        }
    )


_PI_2 = 1.570796327  # as written in the reference URDF
_LIM = 3.0543261909900767
_VEL_A = 2.6179938779914944
_VEL_B = 3.141592653589793

# Transcribed from the reference description/indy7.urdf (joints and link
# inertials).  Link k's inertial is attached to joint k-1 because the
# URDF's link0 is the fixed base.
INDY7_PARAMS = {
    "tcp_offset": [0.0, 0.0, 0.06],
    "gravity": [0.0, 0.0, -9.81],
    "joints": [
        dict(  # joint0: link0 -> link1
            xyz=[0.0, 0.0, 0.0775], rpy=[0.0, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
            effort=431.97, lower=-_LIM, upper=_LIM, velocity=_VEL_A,
            mass=11.44444535,
            com=[-0.00023749, -0.04310313, 0.13245396],
            inertia=[0.35065005, 0.00011931, -0.00037553,
                     0.304798, -0.10984447, 0.06003147],
        ),
        dict(  # joint1: link1 -> link2
            xyz=[0.0, -0.109, 0.222], rpy=[_PI_2, _PI_2, 0.0],
            axis=[0.0, 0.0, 1.0],
            effort=431.97, lower=-_LIM, upper=_LIM, velocity=_VEL_A,
            mass=5.84766553,
            com=[-0.29616699, 2.254e-05, 0.04483069],
            inertia=[0.03599743, -4.693e-05, -0.05240346,
                     0.72293306, 1.76e-06, 0.70024119],
        ),
        dict(  # joint2: link2 -> link3
            xyz=[-0.45, 0.0, -0.0305], rpy=[0.0, 0.0, 0.0],
            axis=[0.0, 0.0, 1.0],
            effort=197.23, lower=-_LIM, upper=_LIM, velocity=_VEL_A,
            mass=2.68206064,
            com=[-0.16804016, 0.00021421, -0.07000383],
            inertia=[0.0161721, -0.00011817, 0.03341882,
                     0.11364055, -4.371e-05, 0.10022522],
        ),
        dict(  # joint3: link3 -> link4
            xyz=[-0.267, 0.0, -0.075], rpy=[-_PI_2, 0.0, _PI_2],
            axis=[0.0, 0.0, 1.0],
            effort=79.79, lower=-_LIM, upper=_LIM, velocity=_VEL_B,
            mass=2.12987371,
            com=[-0.00026847, -0.0709844, 0.07649128],
            inertia=[0.02798891, 3.893e-05, -4.768e-05,
                     0.01443076, -0.01266296, 0.01496211],
        ),
        dict(  # joint4: link4 -> link5
            xyz=[0.0, -0.114, 0.083], rpy=[_PI_2, _PI_2, 0.0],
            axis=[0.0, 0.0, 1.0],
            effort=79.79, lower=-_LIM, upper=_LIM, velocity=_VEL_B,
            mass=2.22412271,
            com=[-0.09796232, -0.00023114, 0.06445892],
            inertia=[0.01105297, 5.517e-05, -0.01481977,
                     0.03698291, -3.74e-05, 0.02754795],
        ),
        dict(  # joint5: link5 -> link6
            xyz=[-0.168, 0.0, 0.069], rpy=[-_PI_2, 0.0, _PI_2],
            axis=[0.0, 0.0, 1.0],
            effort=79.79, lower=-3.7524578917878086, upper=3.7524578917878086,
            velocity=_VEL_B,
            mass=0.38254932,
            com=[8.147e-05, -0.00046556, 0.03079097],
            inertia=[0.00078982, -3.4e-07, 8.3e-07,
                     0.00079764, -5.08e-06, 0.00058319],
        ),
    ],
}


def indy7(
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> RobotModel:
    """The Neuromeka Indy7 6-DOF manipulator (embedded parameters)."""
    return _make_model(INDY7_PARAMS, dtype, device)

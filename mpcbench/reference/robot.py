"""The Neuromeka Indy7 as plain data: a frozen copy of the published URDF's
joints and link inertials, and the seeded inertial error of the perturbed
plant.

Independent of the program under test: nothing here is imported from it.
The numbers are the reference description's (description/indy7.urdf of
A2R-Lab/indy7-mpc); link k's inertial belongs to joint k-1, since the
URDF's link0 is the fixed base.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_PI_2 = 1.570796327  # as written in the URDF
_LIM = 3.0543261909900767
_VEL_A = 2.6179938779914944
_VEL_B = 3.141592653589793

# (xyz, rpy, axis, effort, lower, upper, velocity, mass, com, inertia
#  [ixx, ixy, ixz, iyy, iyz, izz]) of joints 0-5.
JOINTS = (
    ((0.0, 0.0, 0.0775), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), 431.97, -_LIM, _LIM, _VEL_A,
     11.44444535, (-0.00023749, -0.04310313, 0.13245396),
     (0.35065005, 0.00011931, -0.00037553, 0.304798, -0.10984447, 0.06003147)),
    ((0.0, -0.109, 0.222), (_PI_2, _PI_2, 0.0), (0.0, 0.0, 1.0), 431.97, -_LIM, _LIM, _VEL_A,
     5.84766553, (-0.29616699, 2.254e-05, 0.04483069),
     (0.03599743, -4.693e-05, -0.05240346, 0.72293306, 1.76e-06, 0.70024119)),
    ((-0.45, 0.0, -0.0305), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), 197.23, -_LIM, _LIM, _VEL_A,
     2.68206064, (-0.16804016, 0.00021421, -0.07000383),
     (0.0161721, -0.00011817, 0.03341882, 0.11364055, -4.371e-05, 0.10022522)),
    ((-0.267, 0.0, -0.075), (-_PI_2, 0.0, _PI_2), (0.0, 0.0, 1.0), 79.79, -_LIM, _LIM, _VEL_B,
     2.12987371, (-0.00026847, -0.0709844, 0.07649128),
     (0.02798891, 3.893e-05, -4.768e-05, 0.01443076, -0.01266296, 0.01496211)),
    ((0.0, -0.114, 0.083), (_PI_2, _PI_2, 0.0), (0.0, 0.0, 1.0), 79.79, -_LIM, _LIM, _VEL_B,
     2.22412271, (-0.09796232, -0.00023114, 0.06445892),
     (0.01105297, 5.517e-05, -0.01481977, 0.03698291, -3.74e-05, 0.02754795)),
    ((-0.168, 0.0, 0.069), (-_PI_2, 0.0, _PI_2), (0.0, 0.0, 1.0), 79.79,
     -3.7524578917878086, 3.7524578917878086, _VEL_B,
     0.38254932, (8.147e-05, -0.00046556, 0.03079097),
     (0.00078982, -3.4e-07, 8.3e-07, 0.00079764, -5.08e-06, 0.00058319)),
)
GRAVITY = (0.0, 0.0, -9.81)


@dataclasses.dataclass(frozen=True)
class Robot:
    """A fixed-base serial chain of revolute joints, as float tensors.

    Joint i's frame sits at ``p[i]`` in its parent's frame, rotated by
    ``R[i] @ rot(axis[i], q_i)``; link i's inertial (``mass``, centre of
    mass ``com`` and ``I_com`` about it) is written in joint i's frame."""

    R: torch.Tensor        # (6, 3, 3)
    p: torch.Tensor        # (6, 3)
    axis: torch.Tensor     # (6, 3)
    mass: torch.Tensor     # (6,)
    com: torch.Tensor      # (6, 3)
    I_com: torch.Tensor    # (6, 3, 3)
    effort: torch.Tensor   # (6,)
    q_lo: torch.Tensor     # (6,)
    q_hi: torch.Tensor     # (6,)
    gravity: torch.Tensor  # (3,)

    def to(self, dtype) -> "Robot":
        return Robot(**{f.name: getattr(self, f.name).to(dtype)
                        for f in dataclasses.fields(self)})


def rpy(r: float, p: float, y: float) -> np.ndarray:
    """URDF roll-pitch-yaw: Rz(y) Ry(p) Rx(r)."""
    cr, sr, cp, sp, cy, sy = (math.cos(r), math.sin(r), math.cos(p), math.sin(p),
                              math.cos(y), math.sin(y))
    Rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    Ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    return Rz @ Ry @ Rx


def indy7(dtype=torch.float64) -> Robot:
    """The Indy7 from :data:`JOINTS`, computed in float64, cast to ``dtype``."""
    col = lambda k: [j[k] for j in JOINTS]
    inertia = []
    for ixx, ixy, ixz, iyy, iyz, izz in col(9):
        inertia.append([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    return Robot(
        R=t([rpy(*j[1]) for j in JOINTS]), p=t(col(0)), axis=t(col(2)), mass=t(col(7)),
        com=t(col(8)), I_com=t(inertia), effort=t(col(3)), q_lo=t(col(4)), q_hi=t(col(5)),
        gravity=t(GRAVITY),
    ).to(dtype)


_MASK64 = (1 << 64) - 1


def uniform_draws(seed: int, n: int) -> np.ndarray:
    """``n`` draws in [-1, 1): splitmix64 from ``seed``, 53 bits each."""
    out, state = [], seed & _MASK64
    for _ in range(n):
        state = (state + 0x9E3779B97F4A7C15) & _MASK64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
        out.append(2.0 * ((z >> 11) * 2.0 ** -53) - 1.0)
    return np.asarray(out)


def perturbed(robot: Robot, pct: float, seed: int) -> Robot:
    """The plant's inertial error: link i's mass scaled by 1 + pct * d_i and
    its ``I_com`` by 1 + pct * d_(6+i), the d being :func:`uniform_draws`."""
    if pct == 0.0:
        return robot
    d = torch.as_tensor(uniform_draws(seed, 12), dtype=robot.mass.dtype)
    return dataclasses.replace(robot, mass=robot.mass * (1.0 + pct * d[:6]),
                               I_com=robot.I_com * (1.0 + pct * d[6:])[:, None, None])

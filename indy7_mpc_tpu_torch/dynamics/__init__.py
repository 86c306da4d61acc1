"""Readable rigid-body dynamics on tensors (port of ``indy7_mpc_tpu/dynamics``).

Functions of a ``RobotModel`` that broadcast over leading batch dims; the
oracle of the lane-major engine (``ops/lane_rbd.py``) and of the kernels.
"""
from .aba import aba, forward_dynamics_aba
from .integrators import euler_step, rk4_step, split_state
from .kinematics import ee_pos, ee_pos_jacobian, joint_frames, tcp_pos
from .rnea import (
    bias_forces,
    crba,
    forward_dynamics,
    rnea,
    world_wrench_to_ee_joint,
)

__all__ = [
    "joint_frames",
    "ee_pos",
    "tcp_pos",
    "ee_pos_jacobian",
    "rnea",
    "crba",
    "bias_forces",
    "forward_dynamics",
    "world_wrench_to_ee_joint",
    "aba",
    "forward_dynamics_aba",
    "euler_step",
    "rk4_step",
    "split_state",
]

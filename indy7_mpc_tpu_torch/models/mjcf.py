"""Generic MJCF (MuJoCo XML) -> :class:`RobotModel` parser (port of
``models/mjcf.py``).

The reference runs its ground-truth plant from ``description/indy7.xml``
through MuJoCo while the controller's model comes from the URDF through
Pinocchio: two independent descriptions of the same robot, so closed-loop
validation carries real model-source mismatch.  This parser gives the port
the same property: build the PLANT's RobotModel from the MJCF
(``run_sampled_mpc(..., plant_model=indy7_mjcf())``) while the controller
solves on the URDF-derived model.

Supported subset (everything the Indy7 MJCF uses): serial chains of
``<body pos quat>`` with one hinge ``<joint axis range>`` each,
``<inertial pos quat mass diaginertia>`` (principal-axis form),
``<actuator><motor ctrlrange>`` effort limits, and
``<sensor><actuatorfrc noise>`` (returned by :func:`mjcf_meta`, the
plant's actuation-noise level).

MJCF carries no velocity limits and no tool frame; ``velocity_limit`` is
+inf and ``tcp_offset`` zero (the EE frame is the last joint frame, the
reference's joint-6 EE convention).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from .robot import RobotModel
from .urdf import _parse_root

#: The port's own copy of the Indy7 MJCF.
INDY7_MJCF = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "description", "indy7.xml",
)


def _floats(s, default=None):
    if s is None:
        return None if default is None else list(default)
    return [float(x) for x in s.replace(",", " ").split()]


def _quat_mat(q):
    """Rotation matrix from a MuJoCo (w, x, y, z) quaternion."""
    w, x, y, z = np.asarray(q, float) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _body_chain(worldbody):
    """Flatten the (serial) body tree into a list, depth-first."""
    chain = []
    body = worldbody.find("body")
    while body is not None:
        chain.append(body)
        nxt = body.findall("body")
        if len(nxt) > 1:
            raise ValueError("only serial chains are supported")
        body = nxt[0] if nxt else None
    return chain


def parse_mjcf(path_or_str, dtype=torch.float32, device=None) -> RobotModel:
    """Parse an MJCF file (path or XML string) into a :class:`RobotModel`."""
    root = _parse_root(path_or_str, "mujoco")
    comp = root.find("compiler")
    if comp is not None and comp.get("angle", "degree") != "radian":
        raise ValueError("only angle='radian' MJCF files are supported")

    # Effort limits from the actuator block, keyed by joint name.
    ctrlrange = {}
    act = root.find("actuator")
    if act is not None:
        for m in act.findall("motor"):
            rng = _floats(m.get("ctrlrange"))
            gear = _floats(m.get("gear"), [1.0])[0]
            if rng is not None:
                ctrlrange[m.get("joint")] = abs(rng[1]) * gear

    bodies = _body_chain(root.find("worldbody"))
    nj = len(bodies)
    tree_R = np.zeros((nj, 3, 3))
    tree_p = np.zeros((nj, 3))
    axis = np.zeros((nj, 3))
    mass = np.zeros(nj)
    com = np.zeros((nj, 3))
    I_com = np.zeros((nj, 3, 3))
    eff = np.full(nj, np.inf)
    qlo = np.full(nj, -np.inf)
    qhi = np.full(nj, np.inf)

    for i, body in enumerate(bodies):
        tree_p[i] = _floats(body.get("pos"), [0, 0, 0])
        tree_R[i] = _quat_mat(_floats(body.get("quat"), [1, 0, 0, 0]))

        joints = body.findall("joint")
        if len(joints) != 1:
            raise ValueError(f"body {body.get('name')}: exactly one joint "
                             "per body is supported")
        j = joints[0]
        if j.get("type", "hinge") != "hinge":
            raise ValueError("only hinge joints are supported")
        if _floats(j.get("pos"), [0, 0, 0]) != [0.0, 0.0, 0.0]:
            raise ValueError("joint pos offsets are not supported")
        axis[i] = _floats(j.get("axis"), [0, 0, 1])
        rng = _floats(j.get("range"))
        if rng is not None:
            qlo[i], qhi[i] = rng
        frc = _floats(j.get("actuatorfrcrange"))
        name = j.get("name")
        if name in ctrlrange:
            eff[i] = ctrlrange[name]
        elif frc is not None:
            eff[i] = abs(frc[1])

        ine = body.find("inertial")
        if ine is not None:
            mass[i] = float(ine.get("mass"))
            com[i] = _floats(ine.get("pos"), [0, 0, 0])
            Rq = _quat_mat(_floats(ine.get("quat"), [1, 0, 0, 0]))
            diag = ine.get("diaginertia")
            if diag is not None:
                I = np.diag(_floats(diag))
            else:
                ixx, iyy, izz, ixy, ixz, iyz = _floats(ine.get("fullinertia"))
                I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
            I_com[i] = Rq @ I @ Rq.T

    arr = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
    return RobotModel(
        tree_R=arr(tree_R),
        tree_p=arr(tree_p),
        axis=arr(axis),
        mass=arr(mass),
        com=arr(com),
        I_com=arr(I_com),
        tcp_offset=arr(np.zeros(3)),
        gravity=arr([0.0, 0.0, -9.81]),
        effort_limit=arr(eff),
        velocity_limit=arr(np.full(nj, np.inf)),
        q_lower=arr(qlo),
        q_upper=arr(qhi),
    )


def mjcf_meta(path_or_str) -> dict:
    """Non-model metadata: per-joint actuator-force sensor noise and the
    actuators it belongs to."""
    root = _parse_root(path_or_str, "mujoco")
    noise = {}
    sens = root.find("sensor")
    if sens is not None:
        for s in sens.findall("actuatorfrc"):
            n = s.get("noise")
            if n is not None:
                noise[s.get("actuator")] = float(n)
    return {"actuatorfrc_noise": noise}


def indy7_mjcf(dtype=torch.float32, device=None) -> RobotModel:
    """The port's copy of the Indy7 MJCF (description/indy7.xml) as a
    RobotModel: the independent plant-side description of the robot."""
    return parse_mjcf(INDY7_MJCF, dtype=dtype, device=device)

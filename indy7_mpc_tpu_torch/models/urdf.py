"""Generic URDF -> :class:`RobotModel` parser (port of ``models/urdf.py``).

Produces the same serial-chain model as the embedded Indy7 parameters, so
any fixed-base serial revolute arm URDF can drive the port (in place of
the reference's ``pin.buildModelsFromUrdf``).

Handling of fixed joints: a fixed joint's placement is folded into the next
revolute joint's tree placement; trailing fixed joints (tool frames like the
Indy7 ``tcp``) are folded into ``tcp_offset``.  Link inertias attached to
fixed links between revolute joints are not merged (the Indy7 URDF has
none besides the immobile base).
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np
import torch

from .robot import RobotModel, _make_model, rpy_matrix


def _floats(s, default):
    if s is None:
        return list(default)
    return [float(x) for x in s.replace(",", " ").split()]


def _origin(elem):
    o = elem.find("origin") if elem is not None else None
    if o is None:
        return np.zeros(3), np.zeros(3)
    xyz = np.array(_floats(o.get("xyz"), [0, 0, 0]))
    rpy = np.array(_floats(o.get("rpy"), [0, 0, 0]))
    return xyz, rpy


def _link_inertial(link_elem):
    inertial = link_elem.find("inertial") if link_elem is not None else None
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = float(inertial.find("mass").get("value"))
    xyz, rpy = _origin(inertial)
    ine = inertial.find("inertia")
    ixx, ixy, ixz, iyy, iyz, izz = (
        float(ine.get(k, 0)) for k in ("ixx", "ixy", "ixz", "iyy", "iyz", "izz")
    )
    I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    R = rpy_matrix(*rpy)
    # COM and inertia in the link (= joint) frame; the COM offset xyz is
    # already there.
    return mass, xyz, R @ I @ R.T


def _parse_root(path_or_str, tag):
    text = str(path_or_str)
    if "\n" in text or f"<{tag}" in text:
        return ET.fromstring(path_or_str)
    return ET.parse(path_or_str).getroot()


def parse_urdf(path_or_str, dtype=torch.float32, device=None) -> RobotModel:
    """Parse a URDF file (path or XML string) into a :class:`RobotModel`."""
    root = _parse_root(path_or_str, "robot")
    links = {l.get("name"): l for l in root.findall("link")}
    joints = root.findall("joint")
    child_of = {}  # parent link -> joint elements
    for j in joints:
        child_of.setdefault(j.find("parent").get("link"), []).append(j)

    # The root link: a link that is never a child.
    children = {j.find("child").get("link") for j in joints}
    roots = [name for name in links if name not in children]
    if len(roots) != 1:
        raise ValueError(f"expected one root link, got {roots}")

    # Walk the chain, folding fixed joints.
    chain, tree_Rs = [], []
    pending_R, pending_p = np.eye(3), np.zeros(3)
    link = roots[0]
    while link in child_of:
        if len(child_of[link]) != 1:
            raise ValueError("only serial chains are supported")
        j = child_of[link][0]
        xyz, rpy = _origin(j)
        R_j = rpy_matrix(*rpy)
        jtype = j.get("type")
        child = j.find("child").get("link")
        if jtype == "fixed":
            pending_p = pending_p + pending_R @ xyz
            pending_R = pending_R @ R_j
            link = child
            continue
        if jtype not in ("revolute", "continuous"):
            raise ValueError(f"unsupported joint type {jtype}")
        tree_p = pending_p + pending_R @ xyz
        tree_Rs.append(pending_R @ R_j)
        pending_R, pending_p = np.eye(3), np.zeros(3)
        ax = j.find("axis")
        axis = _floats(ax.get("xyz") if ax is not None else None, [1, 0, 0])
        lim = j.find("limit")
        limit = lambda k, d: float(lim.get(k, d)) if lim is not None else d
        mass, com, I_com = _link_inertial(links.get(child))
        chain.append(dict(
            xyz=tree_p.tolist(), rpy=[0.0, 0.0, 0.0], axis=axis,
            effort=limit("effort", np.inf), lower=limit("lower", -np.inf),
            upper=limit("upper", np.inf), velocity=limit("velocity", np.inf),
            mass=mass, com=com.tolist(),
            inertia=[I_com[0, 0], I_com[0, 1], I_com[0, 2],
                     I_com[1, 1], I_com[1, 2], I_com[2, 2]],
        ))
        link = child
    # The trailing fixed transform becomes the tool offset (its rotation is
    # dropped: the reference's tcp joint is a pure translation).
    params = {"tcp_offset": pending_p.tolist(), "joints": chain}
    model = _make_model(params, dtype, device)
    # _make_model builds R from rpy (identity here); put in the exact R.
    return dataclasses.replace(
        model, tree_R=torch.as_tensor(np.stack(tree_Rs), dtype=dtype, device=device)
    )

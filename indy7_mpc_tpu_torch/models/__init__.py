"""Robot models (port of indy7_mpc_tpu/models).

The description files are the port's own copies under ``description/``
(physical robot data of the reference's URDF and MJCF).
"""
import os

import torch

from .mjcf import INDY7_MJCF, indy7_mjcf, mjcf_meta, parse_mjcf
from .robot import INDY7_PARAMS, RobotModel, indy7
from .urdf import parse_urdf

DESCRIPTION_DIR = os.path.dirname(INDY7_MJCF)
INDY7_URDF = os.path.join(DESCRIPTION_DIR, "indy7.urdf")


def indy7_from_urdf(dtype=torch.float32, device=None) -> RobotModel:
    """The Indy7 model parsed from the port's copy of the URDF (a
    round-trip of the embedded parameters of :func:`indy7`)."""
    return parse_urdf(INDY7_URDF, dtype=dtype, device=device)


__all__ = [
    "INDY7_PARAMS",
    "RobotModel",
    "indy7",
    "indy7_from_urdf",
    "indy7_mjcf",
    "parse_urdf",
    "parse_mjcf",
    "mjcf_meta",
    "INDY7_URDF",
    "INDY7_MJCF",
    "DESCRIPTION_DIR",
]

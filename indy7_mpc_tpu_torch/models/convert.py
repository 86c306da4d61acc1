"""Carry parameters and loop state over from numpy arrays.

Both packages can express their models and loop carries as dictionaries
of numpy arrays (``{field: np.asarray(value)}``), which is how a model or
a closed-loop state moves from the TPU package into this one and back.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .robot import FIELDS, RobotModel


def robot_model_from_numpy(
    fields: Mapping[str, np.ndarray], dtype=None, device=None
) -> RobotModel:
    """A RobotModel from the TPU package's RobotModel fields as numpy
    arrays; each keeps its dtype unless ``dtype`` is given."""
    return RobotModel(
        **{
            f: torch.as_tensor(np.array(fields[f]), dtype=dtype, device=device)
            for f in FIELDS
        }
    )


def carry_from_numpy(arrays: Mapping[str, np.ndarray], dtype=None, device=None):
    """A SampledLoopCarry from numpy arrays of its fields.

    Extra entries (the TPU carry's PRNG ``key``) are ignored: this package
    draws from a torch.Generator.  ``ref_offset`` becomes int64.
    """
    from ..mpc.sampled import SampledLoopCarry

    out = {}
    for f in SampledLoopCarry._fields:
        a = np.array(arrays[f])  # a writable copy
        if f == "ref_offset":
            out[f] = torch.as_tensor(a.astype(np.int64), device=device)
        else:
            out[f] = torch.as_tensor(a, dtype=dtype, device=device)
    return SampledLoopCarry(**out)


def carry_to_numpy(carry) -> dict:
    """The carry's fields as numpy arrays (copied to the host)."""
    return {f: getattr(carry, f).detach().cpu().numpy() for f in carry._fields}

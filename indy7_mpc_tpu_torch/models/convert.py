"""Carry parameters and loop state over from numpy arrays.

Both packages can express their models, loop carries and controller
checkpoints as dictionaries of numpy arrays (``{field: np.asarray(value)}``),
which is how a model or a closed-loop or controller state moves from the
TPU package into this one and back.
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


def controller_state_from_npz(npz, device=None) -> dict:
    """A ``runtime.SampledController`` state from a checkpoint file.

    ``npz`` is a path or an opened ``np.load`` mapping, written by either
    package's ``SampledController.save_checkpoint``.  Every field but the
    random state carries over (the TPU package's PRNG ``key`` and this
    package's ``generator_state`` are left out): ``ref_offset`` (float),
    ``f_ext_actual`` (numpy), and float32 tensors on ``device`` for
    ``f_batch``, ``X_best``, ``U_best``, ``u_last`` and ``x_last`` (None
    when the checkpoint holds NaNs: no state seen yet).
    """
    if isinstance(npz, (str, bytes)) or hasattr(npz, "__fspath__"):
        with np.load(npz) as z:
            return controller_state_from_npz(z, device)

    def tensor(name):
        return torch.as_tensor(np.array(npz[name]), dtype=torch.float32, device=device)

    x_last = np.asarray(npz["x_last"])
    return {
        "ref_offset": float(npz["ref_offset"]),
        "f_ext_actual": np.array(npz["f_ext_actual"]),
        "f_batch": tensor("f_batch"),
        "X_best": tensor("X_best"),
        "U_best": tensor("U_best"),
        "x_last": None if np.any(np.isnan(x_last)) else tensor("x_last"),
        "u_last": tensor("u_last"),
    }

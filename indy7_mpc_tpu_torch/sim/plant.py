"""Ground-truth plant (port of ``indy7_mpc_tpu/sim/plant.py``), lane-major.

States are (12, L) tensors and controls (6, L); a single state is L = 1.
The actuation noise is drawn by the caller and passed in, so that a test
can feed the TPU package's random stream to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import PlantConfig
from ..models.robot import RobotModel
from ..ops import lane_rbd as LR

_U64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    """splitmix64 output mix for state ``z`` (bit-identical to the C++
    plant's perturb_model and the TPU package)."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return (z ^ (z >> 31)) & _U64


def perturbation_scales(seed: int, n: int) -> np.ndarray:
    """``n`` deterministic uniform draws in [-1, 1] from splitmix64."""
    out = np.empty(n)
    state = seed & _U64
    for i in range(n):
        state = (state + 0x9E3779B97F4A7C15) & _U64
        u = _splitmix64(state) >> 11  # 53 bits
        out[i] = 2.0 * (u * (2.0 ** -53)) - 1.0
    return out


def perturb_model(model: RobotModel, cfg: PlantConfig) -> RobotModel:
    """Seeded inertial-parameter error: per-link mass and inertia scaled by
    independent factors in [1-pct, 1+pct]."""
    if cfg.param_scale_pct == 0.0:
        return model
    nj = model.nj
    draws = perturbation_scales(cfg.seed, 2 * nj)
    mass_s = 1.0 + cfg.param_scale_pct * draws[:nj]
    inertia_s = 1.0 + cfg.param_scale_pct * draws[nj:]

    def like(a, ref):
        return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)

    return dataclasses.replace(
        model,
        mass=model.mass * like(mass_s, model.mass),
        I_com=model.I_com * like(inertia_s, model.I_com)[:, None, None],
    )


def apply_joint_limits(sm: LR.StaticModel, x, velocity_saturation=False):
    """Hard joint stops after a plant substep: optional velocity
    saturation, then q clamped to its range with the outward velocity
    zeroed.  ``x`` is (12, L)."""
    q, v = x[:6], x[6:]
    lo, hi = sm.q_lower[:, None], sm.q_upper[:, None]
    if velocity_saturation:
        vl = sm.velocity_limit[:, None]
        v = torch.minimum(torch.maximum(v, -vl), vl)
    v = torch.where(q > hi, torch.clamp(v, max=0.0), v)
    v = torch.where(q < lo, torch.clamp(v, min=0.0), v)
    q = torch.minimum(torch.maximum(q, lo), hi)
    return torch.cat([q, v])


def plant_step(
    sm: LR.StaticModel,
    x,
    u,
    dt: float,
    wrench_world=None,
    substeps: int = 1,
    clamp_torque: bool = True,
    friction=None,
    noise: Optional[torch.Tensor] = None,
    enforce_limits: bool = True,
    velocity_saturation: bool = False,
):
    """Advance the plant by ``dt`` under constant torque ``u``.

    x (12, L), u (6, L), wrench_world (6, L) or None.  RK4 with
    ``substeps`` sub-intervals; the wrench is re-mapped to the EE frame at
    the start of each substep.  Torques are clamped to the effort limits.
    ``noise`` (substeps, 6) or (substeps, 6, L) is the actuation noise
    added per substep, already scaled by its standard deviation.
    """
    if clamp_torque:
        el = sm.effort_limit[:, None]
        u = torch.minimum(torch.maximum(u, -el), el)
    h = dt / substeps
    for s in range(substeps):
        us = u
        if noise is not None:
            ns = noise[s]
            us = u + (ns[:, None] if ns.dim() == 1 else ns)
        x = LR.rk4_step(sm, x, us, h, wrench_world=wrench_world, friction=friction)
        if enforce_limits:
            x = apply_joint_limits(sm, x, velocity_saturation)
    return x


def plant_friction(cfg: PlantConfig):
    """``(kv, kc)`` for :func:`plant_step`, or None without friction."""
    if cfg.viscous_friction or cfg.coulomb_friction:
        return (cfg.viscous_friction, cfg.coulomb_friction)
    return None


def predict_next_states(sm: LR.StaticModel, x, u, dt: float, wrench_batch):
    """One-step prediction under each wrench hypothesis (consensus).

    x (12,), u (6,), wrench_batch (6, B) lane-major.  Same state and
    control in every lane, joint stops applied.  Returns (12, B).
    """
    B = wrench_batch.shape[-1]
    return plant_step(
        sm, x[:, None].expand(12, B), u[:, None].expand(6, B), dt,
        wrench_world=wrench_batch,
    )

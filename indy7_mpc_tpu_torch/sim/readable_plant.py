"""The ground-truth plant on the readable dynamics (port of the
``RobotModel`` functions of ``indy7_mpc_tpu/sim/plant.py``).

The readable tick's plant and consensus (``mpc/readable_tick.py``), as the
TPU package's readable tick runs them: RK4 substeps of ``dynamics/`` with
the wrench re-mapped per substep, effort clamping, friction, actuation
noise and joint stops.  ``sim/plant.py`` holds the same plant on the
lane-major engine, the plain version of kernel K2; this one shares only
the plant configuration's model and friction with it
(``perturb_model``, ``plant_friction``).  States broadcast over leading
batch dims, ``(*b, 12)``.  The actuation noise is drawn by the caller and
passed in: scaled to ``plant_step``, standard normal to the step of
``make_plant_step``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import PlantConfig
from ..dynamics.integrators import rk4_step
from ..dynamics.rnea import world_wrench_to_ee_joint
from ..models.robot import RobotModel
from .plant import perturb_model, plant_friction


def apply_joint_limits(model: RobotModel, x, velocity_saturation: bool = False):
    """Hard joint stops after a plant substep: optional velocity
    saturation to the velocity limits, then q clamped to its range with
    the outward velocity zeroed (an inelastic joint stop)."""
    nq = model.nq
    q, v = x[..., :nq], x[..., nq:]
    if velocity_saturation:
        v = torch.minimum(torch.maximum(v, -model.velocity_limit), model.velocity_limit)
    v = torch.where(q > model.q_upper, torch.clamp(v, max=0.0), v)
    v = torch.where(q < model.q_lower, torch.clamp(v, min=0.0), v)
    q = torch.minimum(torch.maximum(q, model.q_lower), model.q_upper)
    return torch.cat([q, v], dim=-1)


def plant_step(
    model: RobotModel,
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

    RK4 with ``substeps`` sub-intervals; the world wrench (*b, 6) is
    re-mapped to the EE joint frame at the start of each substep.  Torques
    are clamped to the effort limits; ``noise`` (substeps, *u.shape),
    already scaled by its standard deviation, is added per substep; with
    ``enforce_limits`` the joint stops follow every substep.
    """
    if clamp_torque:
        u = torch.minimum(torch.maximum(u, -model.effort_limit), model.effort_limit)
    h = dt / substeps
    for s in range(substeps):
        us = u if noise is None else u + noise[s]
        f_l = None
        if wrench_world is not None:
            f_l = world_wrench_to_ee_joint(model, x[..., : model.nq], wrench_world)
        x = rk4_step(model, x, us, h, f_ext_ee=f_l, friction=friction)
        if enforce_limits:
            x = apply_joint_limits(model, x, velocity_saturation)
    return x


def make_plant_step(model: RobotModel, cfg: Optional[PlantConfig]):
    """(plant_model, step_fn) for a PlantConfig.

    ``plant_model`` is ``model`` perturbed by ``cfg`` (on its device and
    dtype).  ``step_fn(x, u, wrench_world, normals, dt)`` advances one
    control tick under it with the configured substeps, friction, velocity
    saturation and actuation noise: ``normals`` (substeps, *u.shape) are
    standard normal draws, scaled here by ``cfg.torque_noise_std``; with
    ``normals=None`` or a zero standard deviation the step is noise-free.
    With ``cfg=None`` it is the nominal single-RK4 plant.
    """
    if cfg is None:
        cfg = PlantConfig()
    pm = perturb_model(model, cfg)
    friction = plant_friction(cfg)

    def step_fn(x, u, wrench_world, normals, dt):
        noisy = cfg.torque_noise_std > 0.0 and normals is not None
        return plant_step(
            pm, x, u, dt,
            wrench_world=wrench_world,
            substeps=cfg.substeps,
            friction=friction,
            noise=cfg.torque_noise_std * normals if noisy else None,
            velocity_saturation=cfg.velocity_saturation,
        )

    return pm, step_fn


def predict_next_states(model: RobotModel, x, u, dt: float, wrench_batch):
    """One-step prediction of ``(x, u)`` under each wrench of
    ``wrench_batch`` (B, 6), joint stops applied: (B, nx)."""
    B = wrench_batch.shape[0]
    return plant_step(model, x.expand(B, -1), u.expand(B, -1), dt, wrench_world=wrench_batch)

"""One plant tick of a single state through the tick-epilogue kernel (K2).

K2 at B = 1 is a whole plant step: its one lane holds a zero wrench
hypothesis and the control ``u``, so its consensus winner is that lane and
its plant step applies ``u`` (torque-clamped, ``cfg.substeps`` RK4
substeps with the configured friction, actuation noise and joint stops)
under the true wrench; its trace FK gives the EE position of the state
before the step.  ``InProcessPlant``, ``run_mpc`` and ``run_tracking_mpc``
step their plant here: on CUDA in one launch, on the CPU through K2's
plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import PlantConfig
from ..ops import lane_rbd as LR
from ..ops.kernels.tick_kernel import tick_epilogue


def kernel_plant_args(x, u, wrench_world=None, noise=None):
    """``tick_epilogue``'s arguments after ``(smc, smp, cfg, dt)`` for one
    plant tick of ``x`` (12,) under ``u`` (6,), the wrench ``wrench_world``
    (6,) or None, and ``noise`` (substeps, 6), already scaled by its
    standard deviation, or None."""
    z = torch.zeros((6, 1), dtype=x.dtype, device=x.device)
    w = z[:, 0] if wrench_world is None else wrench_world.contiguous()
    x, u = x.contiguous(), u.contiguous()
    return (x, x, u, z, u[:, None].contiguous(), w,
            None if noise is None else noise.contiguous())


def kernel_plant_step(
    smc: LR.StaticModel,
    smp: LR.StaticModel,
    cfg: PlantConfig,
    dt: float,
    x,
    u,
    wrench_world=None,
    noise: Optional[torch.Tensor] = None,
):
    """Step the plant model ``smp`` from ``x`` under ``u`` for ``dt``
    (see :func:`kernel_plant_args`).  Returns (x_next (12,), EE position
    of ``x`` under the kinematics of ``smc`` (3,)).  On CUDA the tensors
    must be float32."""
    ep = tick_epilogue(smc, smp, cfg, dt, *kernel_plant_args(x, u, wrench_world, noise))
    return ep.x_next, ep.eep

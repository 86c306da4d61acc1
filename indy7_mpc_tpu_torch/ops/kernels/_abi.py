"""ctypes mirrors of the POD structs the CUDA kernels take by value.

Field order and sizes match ``ModelConsts`` (csrc/rbd.cuh), ``SolveParams``
(csrc/sqp_kernel.cu) and ``PlantParams`` (csrc/tick_kernel.cu).
"""
from __future__ import annotations

import ctypes

from ...config import CostConfig, PlantConfig, SQPConfig
from ..lane_rbd import STATIC_FIELDS, StaticModel

_F, _I = ctypes.c_float, ctypes.c_int

_MODEL_SIZES = {
    "tree_R": 54, "tree_p": 18, "axis": 18, "mass": 6, "h": 18, "I_o": 54,
    "gravity": 3, "q_lower": 6, "q_upper": 6, "effort_limit": 6,
    "velocity_limit": 6,
}


class ModelConsts(ctypes.Structure):
    _fields_ = [(f, _F * _MODEL_SIZES[f]) for f in STATIC_FIELDS]


class SolveParams(ctypes.Structure):
    _fields_ = [
        (n, _F) for n in (
            "dt", "dQ", "R", "QN", "eps", "q_barrier", "q_barrier_margin",
            "merit_mu", "step_tol", "rho_min", "rho_max", "rho_factor",
        )
    ] + [
        (n, _I) for n in (
            "regularize", "max_iters", "num_alphas", "N", "B", "use_wrench",
            "stages",
        )
    ]


class PlantParams(ctypes.Structure):
    _fields_ = [(n, _F) for n in ("dt", "viscous", "coulomb")] + [
        (n, _I) for n in (
            "substeps", "noise", "friction", "velocity_saturation", "B",
        )
    ]


def model_consts(sm: StaticModel) -> ModelConsts:
    host = sm.host
    return ModelConsts(
        **{f: (_F * _MODEL_SIZES[f])(*host[f]) for f in STATIC_FIELDS}
    )


def solve_params(
    cost: CostConfig, sqp: SQPConfig, dt: float, N: int, B: int,
    use_wrench: bool, stages: int = 4,
) -> SolveParams:
    return SolveParams(
        dt=dt, dQ=cost.dQ, R=cost.R, QN=cost.QN, eps=cost.eps,
        q_barrier=cost.q_barrier, q_barrier_margin=cost.q_barrier_margin,
        merit_mu=sqp.merit_mu, step_tol=sqp.step_tol, rho_min=sqp.rho,
        rho_max=sqp.rho_max, rho_factor=sqp.rho_factor,
        regularize=int(cost.regularize), max_iters=sqp.max_iters,
        num_alphas=sqp.num_alphas, N=N, B=B, use_wrench=int(use_wrench),
        stages=stages,
    )


def plant_params(
    cfg: PlantConfig, dt: float, B: int, noise: bool, plant: bool = True
) -> PlantParams:
    """K2's plant settings; ``plant=False`` sets 0 substeps, which skips
    the plant step."""
    return PlantParams(
        dt=dt, viscous=cfg.viscous_friction, coulomb=cfg.coulomb_friction,
        substeps=cfg.substeps if plant else 0, noise=int(noise),
        friction=int(bool(cfg.viscous_friction or cfg.coulomb_friction)),
        velocity_saturation=int(cfg.velocity_saturation), B=B,
    )

"""Configuration dataclasses (the same fields and defaults as the TPU
package's ``indy7_mpc_tpu/config.py``).

Kept as a copy so that this package runs without the TPU package present;
tests/test_torch_model.py pins every field and default to the original.
The port's functions read these by attribute, so either package's config
objects work with it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostConfig:
    """End-effector tracking cost.

    Running EE-position weight 1, terminal weight ``QN``; velocity and
    torque regularization ``dQ``/``R`` scaled by ``1/(|ee_err| + eps)``
    when ``regularize`` is on.  ``q_barrier`` weights the joint-range
    barrier ``sum_j relu(|q_j| - (limit_j - margin))^2`` (0 disables it).
    ``formulation``: "gn" (delta-variable Gauss-Newton: kernel K1 and the
    readable solver) or "reference" (the reference's absolute-variable
    blocks: the readable solver only).
    """

    dQ: float = 0.01
    R: float = 1e-5
    QN: float = 100.0
    regularize: bool = True
    eps: float = 1.0
    q_barrier: float = 25.0
    q_barrier_margin: float = 0.1
    formulation: str = "gn"


@dataclasses.dataclass(frozen=True)
class SQPConfig:
    """SQP outer loop: iteration cap, merit line search over ``num_alphas``
    halving alphas, step-norm exit, Levenberg rho backoff.  ``qp_backend``:
    "riccati" (the exact sweep: K1 and the readable solver), or, in the
    readable solver only, "riccati_pscan" (the same QP, its backward pass
    as a parallel scan over the horizon), "pcg" (the dual Schur-complement
    PCG with a block-Jacobi preconditioner, the reference CUDA solver's
    method) or "admm" (OSQP's ADMM on a block-tridiagonal Cholesky
    factored once, the reference CPU path's method)."""

    max_iters: int = 2
    merit_mu: float = 10.0
    num_alphas: int = 8
    step_tol: float = 1e-3
    rho: float = 1e-6
    rho_max: float = 1e2
    rho_factor: float = 4.0
    qp_backend: str = "riccati"
    pcg_tol: float = 1e-7
    pcg_max_iters: int = 60
    # ADMM (OSQP's sigma and alpha; its penalty fixed at rho * 1e3, since a
    # new penalty would need a new factorization).
    admm_sigma: float = 1e-6
    admm_rho: float = 1e3
    admm_alpha: float = 1.6
    admm_eps: float = 1e-6
    admm_max_iters: int = 200
    # Added to every Q block under "pcg": the Schur complement needs a
    # positive definite H, and the GN position Hessians are rank-deficient.
    pcg_primal_reg: float = 1e-4


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Closed-loop MPC settings."""

    N: int = 32            # horizon knots
    dt: float = 0.01       # knot spacing (s)
    sim_substeps: int = 1  # plant RK4 substeps per control tick
    goal_switch_dist: float = 0.1
    divergence_dist: float = 1.1


@dataclasses.dataclass(frozen=True)
class PlantConfig:
    """Ground-truth plant perturbations (model-mismatch validation):
    seeded inertial error, gaussian actuation noise per substep, unmodeled
    friction ``-kv v - kc tanh(v / 0.01)``, finer substeps, optional
    velocity saturation.  Joint position limits are always enforced."""

    substeps: int = 1
    param_scale_pct: float = 0.0
    torque_noise_std: float = 0.0
    viscous_friction: float = 0.0
    coulomb_friction: float = 0.0
    seed: int = 0
    velocity_saturation: bool = False


#: The standard model-mismatch plant: ~4% inertial error, 0.1 N m
#: actuation noise, light friction, 5x finer integration.
PERTURBED_PLANT = PlantConfig(
    substeps=5,
    param_scale_pct=0.04,
    torque_noise_std=0.1,
    viscous_friction=0.05,
    coulomb_friction=0.1,
    seed=7,
)


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Wrench-hypothesis sampling."""

    batch_size: int = 16
    f_ext_std: float = 20.0
    f_ext_resample_std: float = 1.0
    decay: float = 0.97

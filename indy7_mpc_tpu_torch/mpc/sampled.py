"""Sampled MPC: batched wrench-hypothesis estimation and consensus control.

Port of ``indy7_mpc_tpu/mpc/sampled.py``.  B lanes each solve the same
tracking problem under their own hypothesized external wrench; consensus
keeps the lane whose one-step prediction best matches the observed state,
and the hypotheses are resampled around the winner.  The closed loop ticks
:func:`make_loop_tick`'s tick: the two-kernel tick of
``mpc/fused_tick.py`` where kernel K1 covers the configuration and no
solver is injected, else (or with ``fused=False``) the readable tick of
``mpc/readable_tick.py``; either on the fixed buffers of
``mpc/graphed.py`` (on CUDA replayed as captured graphs).  The
host-driven tick (:func:`sampled_tick`, which ``runtime/controller.py``
calls) follows the same choice.

Random numbers come from an explicit ``torch.Generator`` on the carry's
device; a tick can instead take its draws (:class:`TickDraws`) from the
caller, which is how the tests replay the TPU package's random stream.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..config import (
    CostConfig, MPCConfig, PlantConfig, SampleConfig, SQPConfig,
)
from ..models.robot import RobotModel
from ..ops.kernels.tick_kernel import first_argmin
from ..sim.plant import predict_next_states


def init_wrench_batch(
    generator: torch.Generator, cfg: SampleConfig, dtype=torch.float32,
    device=None,
):
    """Initial hypothesis batch: N(0, f_ext_std) forces, zero torques, lane
    0 pinned to zero."""
    f = cfg.f_ext_std * torch.randn(
        (cfg.batch_size, 6), generator=generator, dtype=dtype, device=device
    )
    f[:, 3:] = 0.0
    f[0] = 0.0
    return f


def resample_wrench_batch(normals, f_batch, best_idx, cfg: SampleConfig):
    """Resample around the winner: copy it, add resample_std * normals,
    restore the winner's row, zero torques, re-pin lane 0, decay.

    ``normals`` (B, 6) are standard normal draws; ``best_idx`` is a 0-d
    integer tensor (no host sync)."""
    idx = best_idx.reshape(1)
    f_best = f_batch.index_select(0, idx)
    f = (f_best + cfg.f_ext_resample_std * normals).index_copy(0, idx, f_best)
    f[:, 3:] = 0.0
    f[0] = 0.0
    return f * cfg.decay


def find_best_lane(sm, x_last, u_last, x_obs, dt: float, f_batch):
    """Consensus scoring: replay ``(x_last, u_last)`` under each hypothesis
    of ``f_batch`` (B, 6) and rank the predictions by their distance to
    ``x_obs``.  Returns (winning lane, (B,) distances); a NaN distance wins,
    the first NaN first, as ``jnp.argmin`` does.  ``sm`` is a StaticModel."""
    x_pred = predict_next_states(sm, x_last, u_last, dt, f_batch.T)
    err = torch.linalg.norm(x_pred - x_obs[:, None], dim=0)
    return first_argmin(err), err


class SampledTickResult(NamedTuple):
    u: torch.Tensor            # (nu,) consensus control to apply
    best_idx: torch.Tensor     # () winning lane
    X_best: torch.Tensor       # (N, nx)
    U_best: torch.Tensor       # (N-1, nu)
    f_batch: torch.Tensor      # (B, 6) resampled hypotheses
    f_est: torch.Tensor        # (6,) winning wrench estimate
    sqp_iters: torch.Tensor    # () the winner's accepted SQP steps


def sampled_tick(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    sample_cfg: SampleConfig,
    dt: float,
    generator: Optional[torch.Generator],
    x_obs,
    x_last,
    u_last,
    goals,
    X_warm,
    U_warm,
    f_batch,
    normals=None,
    batch_solve_fn: Optional[Callable] = None,
) -> SampledTickResult:
    """One control tick: batch-solve, score, resample, pick the control.

    The TPU package's ``sampled_tick`` with its PRNG key replaced by
    ``generator`` (on x_obs's device), from which the (B, 6) resampling
    normals are drawn unless ``normals`` is given.  Inside K1's coverage
    and with no ``batch_solve_fn`` it is ``fused_tick.SampledTick``: on
    CUDA it launches K1 and K2, on the CPU it runs their plain versions.
    Otherwise it solves with ``batch_solve_fn`` (default: the readable
    solver, with a warning on a card) and scores on the readable plant
    (``readable_tick.ReadableSampledTick``).  A
    caller that ticks repeatedly should keep one tick module instead
    (:func:`make_sampled_tick`), which builds the model constants once.
    """
    tick = make_sampled_tick(model, cost_cfg, sqp_cfg, sample_cfg, dt, generator,
                             batch_solve_fn, x_obs.device)
    return tick.to(x_obs.device)(
        x_obs, x_last, u_last, goals, X_warm, U_warm, f_batch, normals=normals
    )[0]


def make_sampled_tick(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    sample_cfg: SampleConfig,
    dt: float,
    generator: Optional[torch.Generator] = None,
    batch_solve_fn: Optional[Callable] = None,
    device=None,
):
    """The host-driven tick module for a configuration: the two-kernel
    ``SampledTick`` inside K1's coverage with no injected solver, else a
    ``ReadableSampledTick`` on ``batch_solve_fn`` or the selected default
    (the readable solver; ``device`` is the target, for its warning)."""
    from ..solvers.select import default_batch_solve_fn, kernel_supports

    if batch_solve_fn is None and kernel_supports(cost_cfg, sqp_cfg):
        from .fused_tick import SampledTick

        return SampledTick(model, cost_cfg, sqp_cfg, sample_cfg, dt, generator)
    from .readable_tick import ReadableSampledTick

    if batch_solve_fn is None:
        batch_solve_fn = default_batch_solve_fn(model, cost_cfg, sqp_cfg, dt, device)
    return ReadableSampledTick(model, cost_cfg, sqp_cfg, sample_cfg, dt, generator,
                               batch_solve_fn)


class SampledLoopCarry(NamedTuple):
    x: torch.Tensor          # (12,) plant state
    x_last: torch.Tensor     # (12,) previous state (consensus replay start)
    u_last: torch.Tensor     # (6,) previously applied control
    X_best: torch.Tensor     # (N, 12) winning trajectory (warm start)
    U_best: torch.Tensor     # (N-1, 6)
    f_batch: torch.Tensor    # (B, 6) wrench hypotheses
    f_true: torch.Tensor     # (6,) true disturbance on the plant
    ref_offset: torch.Tensor  # () int64 reference index


class SampledTrace(NamedTuple):
    tracking_error: torch.Tensor  # (T,)
    ee_pos: torch.Tensor          # (T, 3)
    ee_ref: torch.Tensor          # (T, 3)
    q: torch.Tensor               # (T, nq)
    u: torch.Tensor               # (T, nu)
    best_idx: torch.Tensor        # (T,)
    f_est: torch.Tensor           # (T, 6)
    f_true: torch.Tensor          # (T, 6)
    x: torch.Tensor               # (T, nx)


class TickDraws(NamedTuple):
    """One tick's standard normal draws."""

    resample: torch.Tensor           # (B, 6) hypothesis resampling
    walk: torch.Tensor               # (3,) true-wrench random walk
    plant: Optional[torch.Tensor]    # (substeps, 6) actuation noise, or None


def draw_tick(
    generator: Optional[torch.Generator], sample_cfg: SampleConfig,
    plant_cfg: PlantConfig, device, dtype,
) -> TickDraws:
    """One closed-loop tick's draws from ``generator`` (on ``device``); the
    plant noise only when the plant has actuation noise."""
    if generator is None:
        raise ValueError("tick called without draws and without a generator")
    g, B = generator, sample_cfg.batch_size
    return TickDraws(
        resample=torch.randn((B, 6), generator=g, device=device, dtype=dtype),
        walk=torch.randn(3, generator=g, device=device, dtype=dtype),
        plant=torch.randn(
            (plant_cfg.substeps, 6), generator=g, device=device, dtype=dtype
        ) if plant_cfg.torque_noise_std else None,
    )


def init_loop_carry(
    model: RobotModel,
    mpc_cfg: MPCConfig,
    sample_cfg: SampleConfig,
    x0,
    f_true0,
    generator: torch.Generator,
) -> SampledLoopCarry:
    """Cold start: zero trajectories, a fresh hypothesis batch."""
    N, dtype, device = mpc_cfg.N, x0.dtype, x0.device
    X_best = torch.zeros((N, model.nx), dtype=dtype, device=device)
    X_best[0] = x0
    return SampledLoopCarry(
        x=x0,
        x_last=x0,
        u_last=torch.zeros(model.nu, dtype=dtype, device=device),
        X_best=X_best,
        U_best=torch.zeros((N - 1, model.nu), dtype=dtype, device=device),
        f_batch=init_wrench_batch(generator, sample_cfg, dtype, device),
        f_true=torch.as_tensor(f_true0, dtype=dtype, device=device),
        ref_offset=torch.zeros((), dtype=torch.int64, device=device),
    )


def make_loop_tick(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    mpc_cfg: MPCConfig,
    sample_cfg: SampleConfig,
    ref_traj,
    f_true_walk: bool = True,
    batch_solve_fn: Optional[Callable] = None,
    plant_cfg: Optional[PlantConfig] = None,
    plant_model: Optional[RobotModel] = None,
    fused: object = "auto",
    generator: Optional[torch.Generator] = None,
):
    """``tick(carry, draws=None) -> (carry, SampledTrace)``, one closed-loop
    step (controller tick, ground-truth plant step, reference advance), on
    the device of ``ref_traj`` (move it with ``.to``).

    ``fused="auto"`` (default) selects the two-kernel ``FusedLoopTick``
    (mpc/fused_tick.py) when it covers the config: the production solver
    config (gn + riccati) and no injected ``batch_solve_fn``.
    ``fused=True`` forces it, raising ValueError outside the coverage or
    with a ``batch_solve_fn`` (the two-kernel tick runs K1 and takes no
    injected solver; the TPU package's tick drops one silently there);
    ``fused=False`` keeps the readable tick (mpc/readable_tick.py), the
    fused tick's oracle, on ``batch_solve_fn`` or the readable solver.
    Outside the coverage the readable tick's default solver comes from
    ``solvers.select`` (the readable solver, with a warning on a card).
    """
    from ..solvers.select import default_batch_solve_fn, kernel_supports

    ref = torch.as_tensor(ref_traj)
    covered = batch_solve_fn is None and kernel_supports(cost_cfg, sqp_cfg)
    if fused is True and batch_solve_fn is not None:
        raise ValueError("fused=True builds the two-kernel tick, which runs the SQP kernel "
                         "(K1) and takes no injected batch_solve_fn; pass fused=False or "
                         "'auto' to tick on the injected solver")
    if fused is True or (fused == "auto" and covered):
        from .fused_tick import make_fused_loop_tick

        return make_fused_loop_tick(
            model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, ref,
            f_true_walk=f_true_walk, plant_cfg=plant_cfg, plant_model=plant_model,
            generator=generator,
        )
    if fused not in (False, "auto"):
        raise ValueError(f"fused must be 'auto', True or False, got {fused!r}")
    from .readable_tick import ReadableLoopTick

    if batch_solve_fn is None and not covered:
        batch_solve_fn = default_batch_solve_fn(model, cost_cfg, sqp_cfg, mpc_cfg.dt,
                                                ref.device)
    return ReadableLoopTick(
        model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, ref,
        f_true_walk=f_true_walk, batch_solve_fn=batch_solve_fn, plant_cfg=plant_cfg,
        plant_model=plant_model, generator=generator,
    ).to(ref.device)


def run_sampled_mpc(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    mpc_cfg: MPCConfig,
    sample_cfg: SampleConfig,
    x0,
    ref_traj,
    num_steps: int,
    f_true0,
    generator: torch.Generator,
    f_true_walk: bool = True,
    plant_cfg: Optional[PlantConfig] = None,
    plant_model: Optional[RobotModel] = None,
    carry0: Optional[SampledLoopCarry] = None,
    draws: Optional[Sequence[TickDraws]] = None,
    batch_solve_fn: Optional[Callable] = None,
    fused: object = "auto",
):
    """Closed loop: sampled controller against the device plant.

    Runs on x0's device, on the tick :func:`make_loop_tick` selects: the
    two-kernel tick by default (on CUDA the SQP and tick kernels, on the
    CPU their plain versions), the readable tick with ``fused=False``, an
    injected ``batch_solve_fn`` or a configuration outside K1's coverage.
    Either tick runs on the fixed buffers of ``graphed.LoopTickRunner``: on
    CUDA its first tick runs eagerly and the rest replay captured CUDA
    graphs, the counterpart of the TPU package's ``lax.scan``; on the CPU
    every tick runs eagerly.  The two-kernel tick is captured 10 ticks to
    a graph, the readable tick (tens of thousands of small kernels) one.

    Args:
      ref_traj: (T_ref, 3) EE reference positions, T_ref >= num_steps + N.
      f_true0: (6,) true disturbance wrench applied to the plant.
      generator: torch.Generator on x0's device for the initial hypotheses
        and every tick's draws.
      plant_cfg: ground-truth plant perturbations (config.PERTURBED_PLANT
        is the standard setting); None = the controller's own model.
      plant_model: optional distinct model for the plant.
      carry0: start from this carry instead of :func:`init_loop_carry`.
      draws: per-tick draws to use instead of the generator's.
      batch_solve_fn: ``(xs_b, goals_b, X_b, U_b, wrench_b) -> SQPResult``
        solver for the readable tick.
      fused: "auto", True or False (:func:`make_loop_tick`).

    Returns (final carry, SampledTrace stacked over ticks).
    """
    tick = make_loop_tick(
        model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg,
        torch.as_tensor(ref_traj, dtype=x0.dtype, device=x0.device),
        f_true_walk=f_true_walk, batch_solve_fn=batch_solve_fn, plant_cfg=plant_cfg,
        plant_model=plant_model, fused=fused, generator=generator,
    )
    carry = carry0
    if carry is None:
        carry = init_loop_carry(model, mpc_cfg, sample_cfg, x0, f_true0, generator)
    from .fused_tick import FusedLoopTick
    from .graphed import TICKS_PER_GRAPH, LoopTickRunner

    runner = LoopTickRunner(tick, carry, num_steps, with_draws=draws is not None,
                            ticks_per_graph=TICKS_PER_GRAPH if isinstance(tick, FusedLoopTick)
                            else 1)
    trace = runner.run(num_steps, draws)
    return runner.carry(), trace

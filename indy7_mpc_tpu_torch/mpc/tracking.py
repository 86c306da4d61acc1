"""Figure-8 end-effector tracking MPC, single hypothesis (port of
``indy7_mpc_tpu/mpc/tracking.py``).

Equivalent of the reference's fig-8 runs with a batch-1 solver
(notebooks/gato_mpc_indy7_fig8.ipynb cell 2, ``run_mpc_fig8``;
gato_controller.py with batch_size=1): the N-knot goal window slides one
reference step per control tick, the solver warm-starts from its previous
solution with the measured state pinned, and the plant can carry an
unmodeled constant/wandering wrench.

The TPU package scans the tick in one ``lax.scan``; here it runs on the
fixed buffers of ``mpc/graphed.py``'s ``TickRunner``: on CUDA the first
tick eagerly and every later one a replay of captured CUDA graphs, each
tick launching the SQP kernel (K1) at B = 1 and the tick-epilogue kernel
(K2) at B = 1 as the plant step and the trace FK (``sim/kernel_plant.py``);
on the CPU every tick runs eagerly, both kernels' plain versions in x0's
dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import CostConfig, MPCConfig, PlantConfig, SQPConfig
from ..models.robot import RobotModel
from ..ops import lane_rbd as LR
from ..sim.kernel_plant import kernel_plant_step
from .fused_tick import reference_window
from .graphed import TickRunner


class TrackingCarry(NamedTuple):
    x: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    ref_offset: torch.Tensor


class TrackingTrace(NamedTuple):
    tracking_error: torch.Tensor
    ee_pos: torch.Tensor
    ee_ref: torch.Tensor
    q: torch.Tensor
    u: torch.Tensor
    sqp_iters: torch.Tensor


def make_tracking_tick(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    mpc_cfg: MPCConfig,
    x0,
    ref_traj,
    wrench_world: Optional[torch.Tensor] = None,
    solver_wrench: Optional[torch.Tensor] = None,
):
    """:func:`run_tracking_mpc`'s tick and its cold carry, on x0's device in
    the kernels' dtype (float32 on CUDA, x0's on the CPU): ``(tick,
    carry)`` with ``tick(carry, draws=None) -> (carry, TrackingTrace
    row)``.  A Python loop over the tick is the eager loop;
    ``run_tracking_mpc`` ticks it on a ``graphed.TickRunner``."""
    from ..solvers.select import default_single_solve_fn

    N, dt = mpc_cfg.N, mpc_cfg.dt
    device = x0.device
    kdt = torch.float32 if device.type == "cuda" else x0.dtype
    like = lambda a: None if a is None else torch.as_tensor(a, dtype=kdt, device=device)
    ref_traj, wrench_world, solver_wrench = map(like, (ref_traj, wrench_world, solver_wrench))
    sm = LR.static_model(model.to(device=device, dtype=kdt))
    solve = default_single_solve_fn(model, cost_cfg, sqp_cfg, dt, device)
    plant_cfg = PlantConfig(substeps=mpc_cfg.sim_substeps)

    X0 = torch.zeros((N, model.nx), dtype=kdt, device=device)
    X0[0] = x0
    carry = TrackingCarry(
        x=x0.to(kdt),
        X=X0,
        U=torch.zeros((N - 1, model.nu), dtype=kdt, device=device),
        ref_offset=torch.zeros((), dtype=torch.int64, device=device),
    )

    def tick(carry: TrackingCarry, draws=None):
        goals = reference_window(ref_traj, carry.ref_offset, N)
        res = solve(carry.x, goals, carry.X, carry.U, wrench_world=solver_wrench)
        u = res.U[0]
        x_next, eep = kernel_plant_step(sm, sm, plant_cfg, dt, carry.x, u, wrench_world)
        trace = TrackingTrace(
            tracking_error=torch.linalg.norm(eep - goals[0]),
            ee_pos=eep,
            ee_ref=goals[0],
            q=carry.x[:6],
            u=u,
            sqp_iters=res.stats.iterations,
        )
        X = res.X.clone()
        X[0] = x_next
        return TrackingCarry(x=x_next, X=X, U=res.U, ref_offset=carry.ref_offset + 1), trace

    return tick, carry


def run_tracking_mpc(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    mpc_cfg: MPCConfig,
    x0,
    ref_traj,
    num_steps: int,
    wrench_world: Optional[torch.Tensor] = None,
    solver_wrench: Optional[torch.Tensor] = None,
):
    """Closed-loop fig-8 tracking on x0's device.

    Args:
      ref_traj: (T_ref, 3) reference EE positions (T_ref >= num_steps + N).
      wrench_world: true disturbance on the plant (None = none).
      solver_wrench: wrench the solver models (None = unmodeled
        disturbance, the reference's batch-1 baseline configuration).

    Returns (final TrackingCarry, TrackingTrace stacked over ticks).
    """
    tick, carry = make_tracking_tick(model, cost_cfg, sqp_cfg, mpc_cfg, x0, ref_traj,
                                     wrench_world, solver_wrench)
    runner = TickRunner(tick, carry, num_steps, what="run_tracking_mpc's tick")
    trace = runner.run(num_steps)
    carry = runner.carry()
    cast = lambda t: t.to(x0.dtype) if t.is_floating_point() else t
    return (TrackingCarry(*map(cast, carry)), TrackingTrace(*map(cast, trace)))

"""Point-to-goal receding-horizon MPC (port of
``indy7_mpc_tpu/mpc/point_to_goal.py``).

Re-design of the reference's offline MPC loops (src/osqp_mpc.py:14-71,
src/gato_mpc.py:53-150) as a tick that never reads a device value on the
host: SQP solve, plant step, receding-horizon shift, goal chain advance
and divergence freeze are all tensor operations.  The TPU package scans
the tick in one ``lax.scan``; here it runs on the fixed buffers of
``mpc/graphed.py``'s ``TickRunner``: on CUDA the warm-up solve and the
first tick eagerly, every later tick a replay of captured CUDA graphs; on
the CPU every tick eagerly.

Semantics parity:
  * goal switch when EE-goal distance < goal_switch_dist, cycling through
    the endpoint list (osqp_mpc.py:34-38);
  * divergence freeze (instead of ``break``) when distance >
    divergence_dist (osqp_mpc.py:41-43) — the carry stops updating;
  * warm start by one-knot receding shift with the terminal state
    duplicated.  (Deliberate deviation: the reference fills the shifted
    terminal state with ``[1, ..., 1, 0, ..., 0]`` (osqp_mpc.py:70), which
    measurably poisons warm starts at low SQP iteration counts.)

On CUDA each step launches the SQP kernel (K1) at B = 1, carrying the
solver's rho in ``SolverState``, and the tick-epilogue kernel (K2) at
B = 1 as the plant step; the warm-up solve launches K1 once more.  On the
CPU both run their plain versions in x0's dtype.  An injected
``solve_fn`` is captured with the tick: one that reads the host makes the
capture raise, as ``lax.scan`` refuses an untraceable solver.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import CostConfig, MPCConfig, PlantConfig, SQPConfig
from ..models.robot import RobotModel
from ..ops import lane_rbd as LR
from ..sim.kernel_plant import kernel_plant_step
from ..solvers.sqp import SolverState
from .graphed import TickRunner


class MPCCarry(NamedTuple):
    x: torch.Tensor          # (nx,) plant state
    X: torch.Tensor          # (N, nx) warm-start states
    U: torch.Tensor          # (N-1, nu) warm-start controls
    goal_idx: torch.Tensor   # () int64
    alive: torch.Tensor      # () bool — False after divergence
    state: SolverState


class MPCTrace(NamedTuple):
    x: torch.Tensor          # (T, nx) plant states after each tick
    u: torch.Tensor          # (T, nu) applied torque
    goal_dist: torch.Tensor  # (T,)
    goal_idx: torch.Tensor   # (T,)
    sqp_iters: torch.Tensor  # (T,)


def make_mpc_tick(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    mpc_cfg: MPCConfig,
    x0,
    endpoints,
    wrench_world: Optional[torch.Tensor] = None,
    solve_fn=None,
):
    """:func:`run_mpc`'s tick and its carry after the warm-up solve, on x0's
    device in the kernels' dtype (float32 on CUDA, x0's on the CPU):
    ``(tick, carry)`` with ``tick(carry, draws=None) -> (carry, MPCTrace
    row)``.  A Python loop over the tick is the eager loop; ``run_mpc``
    ticks it on a ``graphed.TickRunner``."""
    from ..solvers.select import default_single_solve_fn

    N, dt = mpc_cfg.N, mpc_cfg.dt
    nx, nu = model.nx, model.nu
    device = x0.device
    kdt = torch.float32 if device.type == "cuda" else x0.dtype
    endpoints = torch.as_tensor(endpoints, dtype=kdt, device=device)
    if wrench_world is not None:
        wrench_world = torch.as_tensor(wrench_world, dtype=kdt, device=device)
    if solve_fn is None:
        solve_fn = default_single_solve_fn(model, cost_cfg, sqp_cfg, dt, device)
    sm = LR.static_model(model.to(device=device, dtype=kdt))
    plant_cfg = PlantConfig(substeps=mpc_cfg.sim_substeps)
    G = endpoints.shape[0]

    def goal_of(idx):
        return endpoints.index_select(0, idx.reshape(1))[0]

    def tick(carry: MPCCarry, draws=None):
        cur_ee = torch.stack(LR.ee_pos(sm, list(carry.x[:6])))
        dist = torch.linalg.norm(cur_ee - goal_of(carry.goal_idx))

        switch = dist < mpc_cfg.goal_switch_dist
        goal_idx = torch.where(switch, (carry.goal_idx + 1) % G, carry.goal_idx)
        goals = goal_of(goal_idx).expand(N, 3)

        alive = carry.alive & (dist <= mpc_cfg.divergence_dist)

        res = solve_fn(carry.x, goals, carry.X, carry.U, carry.state)
        u = res.U[0]
        x_next, _ = kernel_plant_step(sm, sm, plant_cfg, dt, carry.x, u, wrench_world)

        # Receding-horizon shift (osqp_mpc.py:65-69, sane terminal fill).
        X_shift = torch.cat([res.X[1:], res.X[-1:]])
        X_shift[0] = x_next
        U_shift = torch.cat([res.U[1:], res.U[-1:]])

        keep = alive  # a 0-d bool tensor: the freeze costs no host sync

        def sel(new, old):
            return torch.where(keep, new, old)

        new_carry = MPCCarry(
            x=sel(x_next, carry.x),
            X=sel(X_shift, carry.X),
            U=sel(U_shift, carry.U),
            goal_idx=sel(goal_idx, carry.goal_idx),
            alive=alive,
            # The whole solver state, ADMM's warm start included.
            state=SolverState(*(None if n is None else sel(n, o)
                                for n, o in zip(res.state, carry.state))),
        )
        return new_carry, MPCTrace(x=new_carry.x, u=sel(u, torch.zeros_like(u)),
                                   goal_dist=dist, goal_idx=goal_idx,
                                   sqp_iters=res.stats.iterations)

    X0 = torch.zeros((N, nx), dtype=kdt, device=device)
    X0[0] = x0
    carry = MPCCarry(
        x=x0.to(kdt),
        X=X0,
        U=torch.zeros((N - 1, nu), dtype=kdt, device=device),
        goal_idx=torch.zeros((), dtype=torch.int64, device=device),
        alive=torch.ones((), dtype=torch.bool, device=device),
        state=SolverState.init(sqp_cfg, (), device),
    )
    # Warm-up solve from zeros (osqp_mpc.py:26-27).
    warm = solve_fn(carry.x, endpoints[0].expand(N, 3), carry.X, carry.U, carry.state)
    carry = carry._replace(X=warm.X, U=warm.U, state=warm.state)

    return tick, carry


def run_mpc(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    mpc_cfg: MPCConfig,
    x0,
    endpoints,
    num_steps: int,
    wrench_world: Optional[torch.Tensor] = None,
    solve_fn=None,
):
    """Closed-loop point-to-goal MPC on x0's device.

    Args:
      x0: (nx,) initial plant state.
      endpoints: (G, 3) chain of EE goals, cycled on arrival.
      num_steps: control ticks.
      wrench_world: optional true disturbance wrench on the plant.
      solve_fn: optional ``(xs, goals, X, U, state) -> SQPResult``
        single-lane solver override; by default the SQP kernel at B = 1,
        or the readable solver outside its coverage
        (``solvers.select.default_single_solve_fn``).  On CUDA it is
        captured in the tick's graph, so it must not read the host.

    Returns (final MPCCarry, MPCTrace stacked over ticks).
    """
    tick, carry = make_mpc_tick(model, cost_cfg, sqp_cfg, mpc_cfg, x0, endpoints,
                                wrench_world, solve_fn)
    runner = TickRunner(tick, carry, num_steps,
                        what=f"run_mpc's tick with solve_fn={solve_fn!r}")
    trace = runner.run(num_steps)
    carry = runner.carry()
    cast = lambda t: t.to(x0.dtype)
    final = carry._replace(x=cast(carry.x), X=cast(carry.X), U=cast(carry.U))
    return final, trace._replace(x=cast(trace.x), u=cast(trace.u),
                                 goal_dist=cast(trace.goal_dist))

"""One tick of point-to-goal MPC, written plainly.

One arm drives its end effector through a chain of goals, one SQP solve
a tick and no wrench estimation (upstream's ``run_mpc``: osqp_mpc.py:14-71
on the CPU, gato_mpc.py:53-150 on the GPU at B=1).  A tick measures the
end effector's distance to the current goal, moves to the next goal of
the chain once it is under ``switch_dist`` (osqp_mpc.py:34-38), solves
the tracking problem toward the goal held at every knot from the warm
start, applies the first torque to the plant, and shifts the solution by
one knot into the next warm start.

Departures from upstream, each the program's own (``mpc/point_to_goal.py``):

- past ``divergence_dist`` upstream breaks out of its loop
  (osqp_mpc.py:41-43); here the tick freezes: the whole carry, the
  solver's rho included, stays as it was, and the applied torque reads 0;
- the shifted warm start duplicates the terminal state and torque where
  upstream fills the state with [1, ..., 1, 0, ..., 0] (osqp_mpc.py:70);
- the solve is :mod:`sqp`'s Gauss-Newton SQP (upstream's is OSQP or
  GATO's PCG), its Levenberg rho carried from tick to tick (:func:`solve`;
  ``sqp.solve`` starts every call from the configured rho);
- the plant is the controller's own model, stepped by ``substeps`` RK4
  steps with the joint stops, with no friction, noise or wrench
  (upstream steps a simulator at a finer ``sim_dt``, osqp_mpc.py:49).

Tensors carry a leading lane axis L (independent arms) and any float
dtype; the goal index is int64 and ``alive`` bool.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import rbd, sqp
from .robot import Robot, indy7


@dataclass(frozen=True)
class Deployment:
    """A point-to-goal configuration file's numbers (``configs/p2g_*.json``)."""

    N: int
    dt: float
    solver: sqp.SQPSettings
    substeps: int
    switch_dist: float
    divergence_dist: float
    init_q: tuple
    offsets: tuple

    @classmethod
    def from_config(cls, cfg: dict) -> "Deployment":
        c, s, p = cfg["cost"], cfg["sqp"], cfg["plant"]
        if p["param_scale_pct"] or p["torque_noise_std"] or p["viscous_friction"] \
                or p["coulomb_friction"] or p["velocity_saturation"]:
            raise ValueError("the point-to-goal plant is the nominal model: no perturbation, "
                             "noise, friction or velocity saturation")
        return cls(
            N=cfg["horizon"], dt=cfg["dt"],
            solver=sqp.SQPSettings(
                dQ=c["dQ"], R=c["R"], QN=c["QN"], regularize=c["regularize"], eps=c["eps"],
                q_barrier=c["q_barrier"], q_barrier_margin=c["q_barrier_margin"],
                max_iters=s["max_iters"], merit_mu=s["merit_mu"], num_alphas=s["num_alphas"],
                step_tol=s["step_tol"], rho=s["rho"], rho_max=s["rho_max"],
                rho_factor=s["rho_factor"]),
            substeps=p["substeps"], switch_dist=cfg["switch_dist"],
            divergence_dist=cfg["divergence_dist"], init_q=tuple(cfg["init_q"]),
            offsets=tuple(tuple(o) for o in cfg["goals"]["offsets"]))


class Models:
    """The arm's model in one dtype (the controller's and the plant's)."""

    def __init__(self, dep: Deployment, dtype=torch.float64):
        self.dep, self.dtype = dep, dtype
        self.ctl: Robot = indy7(torch.float64).to(dtype)


def goal_chain(dep: Deployment) -> torch.Tensor:
    """(G, 3) float64 goals: the offsets added to the end effector of the
    start pose (the notebooks' FK-derived chain)."""
    q0 = torch.tensor(dep.init_q, dtype=torch.float64)
    return rbd.ee_position(indy7(torch.float64), q0) + torch.tensor(dep.offsets,
                                                                   dtype=torch.float64)


def start_state(dep: Deployment, dtype=torch.float64) -> torch.Tensor:
    """(12,) the arm at rest at the start pose."""
    return torch.cat([torch.tensor(dep.init_q, dtype=dtype), torch.zeros(6, dtype=dtype)])


def solve(robot: Robot, s: sqp.SQPSettings, dt: float, x0, goals, X, U, wrench, rho):
    """``sqp.solve`` with the Levenberg rho (L,) carried in and out:
    ``max_iters`` SQP iterations on L lanes from the warm start (X, U).
    Returns (X, U, rho); X's first state is x0."""
    L, dtype = x0.shape[0], X.dtype
    X = X.clone()
    X[:, 0] = x0
    rho = rho.to(dtype)
    alphas = 0.5 ** torch.arange(s.num_alphas, dtype=dtype)
    cand = torch.cat([alphas, torch.zeros(1, dtype=dtype)])
    done = torch.zeros((L,), dtype=torch.bool)
    zero = torch.zeros((), dtype=dtype)
    for _ in range(s.max_iters):
        A, B, d = sqp.linearize(robot, X, U, wrench, dt)
        Q, g, r_w, r = sqp.cost_blocks(robot, s, X, U, goals)
        dX, dU = sqp.riccati(A, B, d, Q, g, r_w, r, rho)
        c = cand[:, None, None, None]
        merits = sqp.merit(robot, s, X + c * dX, U + c * dU, goals, X[:, 0], wrench, dt)
        ok = merits[:-1] <= merits[-1]
        found = ok.any(0)
        alpha = torch.where(found, alphas[ok.to(torch.int8).argmax(0)], zero)
        take = ~done & (alpha > 0)
        a = torch.where(take, alpha, zero)
        X = X + a[:, None, None] * dX
        U = U + a[:, None, None] * dU
        norm = a * torch.sqrt((dX * dX).sum((1, 2)) + (dU * dU).sum((1, 2)))
        rejected = ~done & ~found
        rho = torch.clamp(torch.where(rejected, rho * s.rho_factor, rho), s.rho, s.rho_max)
        done = done | (take & (norm < s.step_tol))
    return X, U, rho


class Carry(NamedTuple):
    """What a tick hands the next: the state x (L, 12), the warm start X
    (L, N, 12) and U (L, N-1, 6), the goal index (L,), ``alive`` (L,) and
    the solver's rho (L,)."""

    x: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    goal_idx: torch.Tensor
    alive: torch.Tensor
    rho: torch.Tensor


class TickOut(NamedTuple):
    carry: Carry              # the next carry
    u: torch.Tensor           # (L, 6) the torque applied, 0 on a frozen tick
    goal_dist: torch.Tensor   # (L,) distance to the goal held before the switch


def warm_start(m: Models, x0, goals) -> Carry:
    """The carry before the first tick (osqp_mpc.py:26-27): from a zero
    warm start, one solve toward the chain's first goal, rho starting from
    the configured value; the goal index 0 and ``alive``.  x0 (L, 12)."""
    dep, dt = m.dep, m.dtype
    L = x0.shape[0]
    X = torch.zeros((L, dep.N, 12), dtype=dt)
    U = torch.zeros((L, dep.N - 1, 6), dtype=dt)
    target = goals.to(dt)[0].expand(L, dep.N, 3)
    rho = torch.full((L,), dep.solver.rho, dtype=dt)
    X, U, rho = solve(m.ctl, dep.solver, dep.dt, x0.to(dt), target, X, U,
                      torch.zeros((L, 6), dtype=dt), rho)
    return Carry(x0.to(dt), X, U, torch.zeros((L,), dtype=torch.int64),
                 torch.ones((L,), dtype=torch.bool), rho)


def tick(m: Models, c: Carry, goals, u_plant=None) -> TickOut:
    """One tick of L arms on the chain ``goals`` (G, 3).  ``u_plant``
    (L, 6), where given, is the torque the plant steps under in place of
    the tick's own (a comparison's one plant step from another's torque)."""
    dep, dt = m.dep, m.dtype
    goals = goals.to(dt)
    L, G = c.x.shape[0], goals.shape[0]
    dist = torch.linalg.norm(rbd.ee_position(m.ctl, c.x[:, :6]) - goals[c.goal_idx], dim=-1)
    goal_idx = torch.where(dist < dep.switch_dist, (c.goal_idx + 1) % G, c.goal_idx)
    alive = c.alive & (dist <= dep.divergence_dist)
    target = goals[goal_idx][:, None, :].expand(L, dep.N, 3)
    X, U, rho = solve(m.ctl, dep.solver, dep.dt, c.x, target, c.X, c.U,
                      torch.zeros((L, 6), dtype=dt), c.rho)
    u = U[:, 0]
    x_next = rbd.plant_step(m.ctl, c.x, u if u_plant is None else u_plant, dep.dt, None,
                            dep.substeps)
    X_shift = torch.cat([X[:, 1:], X[:, -1:]], 1)
    X_shift[:, 0] = x_next
    U_shift = torch.cat([U[:, 1:], U[:, -1:]], 1)

    def sel(new, old):
        return torch.where(alive.reshape(L, *[1] * (new.dim() - 1)), new, old)

    nxt = Carry(x=sel(x_next, c.x), X=sel(X_shift, c.X), U=sel(U_shift, c.U),
                goal_idx=sel(goal_idx, c.goal_idx), alive=alive, rho=sel(rho, c.rho.to(dt)))
    return TickOut(nxt, sel(u, torch.zeros_like(u)), dist)

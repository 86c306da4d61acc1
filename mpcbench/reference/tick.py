"""One tick of sampled MPC with online wrench estimation, written plainly.

B lanes each hold a hypothesis of the unknown world wrench.  A tick
scores every hypothesis by how well the previous state and torque,
stepped once under it, predict the state now observed (the consensus),
solves the tracking problem of the winning lane from the shared warm
start, applies the solution's first torque, and resamples the hypotheses
around the winner.  In the closed loop the true wrench on the plant
random-walks every ``walk_period`` reference steps.

:class:`Deployment` holds what a configuration file states; the rest of
the module works on torch tensors in any float dtype, lanes first.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import rbd, sqp
from .robot import Robot, indy7, perturbed


@dataclass(frozen=True)
class Deployment:
    """A configuration file's numbers (``configs/*.json``)."""

    B: int
    N: int
    dt: float
    solver: sqp.SQPSettings
    f_ext_std: float
    f_ext_resample_std: float
    decay: float
    substeps: int
    param_scale_pct: float
    torque_noise_std: float
    viscous_friction: float
    coulomb_friction: float
    plant_seed: int
    walk_period: int
    walk_clip: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Deployment":
        c, s, p, w = cfg["cost"], cfg["sqp"], cfg["plant"], cfg["wrench"]
        return cls(
            B=cfg["batch_size"], N=cfg["horizon"], dt=cfg["dt"],
            solver=sqp.SQPSettings(
                dQ=c["dQ"], R=c["R"], QN=c["QN"], regularize=c["regularize"], eps=c["eps"],
                q_barrier=c["q_barrier"], q_barrier_margin=c["q_barrier_margin"],
                max_iters=s["max_iters"], merit_mu=s["merit_mu"], num_alphas=s["num_alphas"],
                step_tol=s["step_tol"], rho=s["rho"], rho_max=s["rho_max"],
                rho_factor=s["rho_factor"]),
            f_ext_std=w["f_ext_std"], f_ext_resample_std=w["f_ext_resample_std"],
            decay=w["decay"], substeps=p["substeps"], param_scale_pct=p["param_scale_pct"],
            torque_noise_std=p["torque_noise_std"], viscous_friction=p["viscous_friction"],
            coulomb_friction=p["coulomb_friction"], plant_seed=p["seed"],
            walk_period=w["walk_period"], walk_clip=w["walk_clip"])


class Models:
    """The controller's model and the plant's, in one dtype."""

    def __init__(self, dep: Deployment, dtype=torch.float64):
        self.dep, self.dtype = dep, dtype
        base = indy7(torch.float64)
        self.ctl: Robot = base.to(dtype)
        self.plant: Robot = perturbed(base, dep.param_scale_pct, dep.plant_seed).to(dtype)

    @property
    def friction(self):
        d = self.dep
        return (d.viscous_friction, d.coulomb_friction) \
            if d.viscous_friction or d.coulomb_friction else None


def goal_window(ref: torch.Tensor, offset: int, N: int) -> torch.Tensor:
    """``ref[offset : offset + N]``, the start held in [0, len - N]."""
    start = min(max(int(offset), 0), ref.shape[0] - N)
    return ref[start:start + N]


def consensus_distances(m: Models, x_obs, x_last, u_last, f_batch):
    """(..., B) distances from the observed state (..., 12) to the previous
    state and torque stepped once, under each hypothesis of f_batch
    (..., B, 6), on the controller's model (one RK4 step, no friction,
    torques clamped, joint stops)."""
    xs = x_last[..., None, :].expand(*f_batch.shape[:-1], 12)
    us = u_last[..., None, :].expand(*f_batch.shape[:-1], 6)
    pred = rbd.plant_step(m.ctl, xs, us, m.dep.dt, f_batch)
    return torch.sqrt(((pred - x_obs[..., None, :]) ** 2).sum(-1))


def resample(dep: Deployment, normals, f_batch, best):
    """New hypotheses (..., B, 6): the winner's force plus
    ``f_ext_resample_std`` times the normals, the winner's own row kept,
    torques zero, lane 0 zero, all times ``decay``."""
    f_best = f_batch.gather(-2, best[..., None, None].expand(*best.shape, 1, 6))
    f = f_best + dep.f_ext_resample_std * normals
    lane = torch.arange(f.shape[-2])
    f = torch.where((lane == best[..., None])[..., None], f_best, f)
    f = torch.cat([f[..., :3], torch.zeros_like(f[..., 3:])], -1)
    f = torch.where((lane == 0)[:, None], torch.zeros_like(f), f)
    return f * dep.decay


def initial_hypotheses(dep: Deployment, normals):
    """The first hypotheses from (B, 6) standard normals: ``f_ext_std``
    times the force draws, torques zero, lane 0 zero."""
    f = dep.f_ext_std * normals
    f = torch.cat([f[..., :3], torch.zeros_like(f[..., 3:])], -1)
    return torch.where((torch.arange(f.shape[-2]) == 0)[:, None], torch.zeros_like(f), f)


def walk(dep: Deployment, f_true, step, offset: int):
    """The true wrench after a tick at reference ``offset``: on a multiple
    of ``walk_period`` its force moves by ``step`` (3,) and is clipped to
    +-``walk_clip``."""
    if int(offset) % dep.walk_period:
        return f_true
    f = f_true.clone()
    f[..., :3] = torch.clamp(f_true[..., :3] + step, -dep.walk_clip, dep.walk_clip)
    return f


def plant(m: Models, x, u, f_true, noise_normals):
    """The perturbed plant over one period from x under u, with the
    actuation noise ``torque_noise_std`` times the (..., substeps, 6)
    normals."""
    d = m.dep
    noise = None if not d.torque_noise_std else d.torque_noise_std * noise_normals
    return rbd.plant_step(m.plant, x, u, d.dt, f_true, d.substeps, m.friction, noise)


@dataclass
class TickOut:
    """One tick's outputs."""

    best: int                 # winning lane
    X: torch.Tensor           # (N, 12) its solution
    U: torch.Tensor           # (N-1, 6)
    f_batch: torch.Tensor     # (B, 6) resampled hypotheses
    f_est: torch.Tensor       # (6,) the winner's hypothesis
    ee: torch.Tensor          # (3,) end effector of the observed state


def controller_tick(m: Models, x_obs, x_last, u_last, goals, X_warm, U_warm, f_batch,
                    normals) -> TickOut:
    """One tick on one observed state (12,): consensus (the nearest
    prediction wins, the first lane of a tie first), the winner's solve from
    the warm start, resampling."""
    best = int(torch.argmin(consensus_distances(m, x_obs, x_last, u_last, f_batch)))
    X, U = sqp.solve(m.ctl, m.dep.solver, m.dep.dt, x_obs[None], goals[None],
                     X_warm[None], U_warm[None], f_batch[best][None])
    f_new = resample(m.dep, normals, f_batch, torch.tensor(best))
    return TickOut(best, X[0], U[0], f_new, f_batch[best].clone(),
                   rbd.ee_position(m.ctl, x_obs[:6]))

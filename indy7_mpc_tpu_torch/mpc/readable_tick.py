"""The readable sampled-MPC ticks (port of ``mpc/sampled.py``'s
``fused=False`` tick and its host tick off the kernels).

:class:`ReadableSampledTick`, the host-driven controller tick: the batched
solve on a ``batch_solve_fn`` (by default the readable solver,
``solvers/sqp.py``), consensus by one-step predictions under each
hypothesis (:func:`readable_consensus`), winner gather and resampling.
:class:`ReadableLoopTick`, the closed-loop tick: that tick, then the
ground-truth plant step, the true-wrench random walk and the trace FK.
The predictions, the plant and the FK run on the readable dynamics
(``dynamics/``, ``sim/readable_plant.py``), as the TPU package's readable
tick does, and share no code with the kernels' plain versions.

They are the oracle of the two-kernel ticks (``mpc/fused_tick.py``) and
the ticks of every configuration outside kernel K1's coverage.  They take
the same draws (:class:`.sampled.TickDraws`) as the kernel ticks, run in
the inputs' dtype on the inputs' device, and launch no kernel of this
package unless the injected solver does.

Both take a lane mesh (``lane_mesh.py``): the hypothesis batch is then
this rank's block of the B lanes, the winner is chosen over every rank
and the resampling uses global lane indices.  By default the mesh is one
rank with no collectives, the single-process tick.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..config import (
    CostConfig, MPCConfig, PlantConfig, SampleConfig, SQPConfig,
)
from ..dynamics.kinematics import ee_pos
from ..models.robot import FIELDS, RobotModel
from ..ops.kernels.tick_kernel import first_argmin
from ..sim.plant import perturb_model, plant_friction
from ..sim.readable_plant import plant_step, predict_next_states
from ..solvers import sqp as sqp_mod
from .fused_tick import reference_window, walk_true_wrench
from .lane_mesh import LaneMesh, cross_rank_consensus, resample_lanes, single_rank_mesh
from .sampled import (
    SampledLoopCarry, SampledTickResult, SampledTrace, TickDraws, draw_tick,
)


def readable_consensus(model: RobotModel, x_last, u_last, x_obs, dt: float, f_batch):
    """Consensus scoring on the readable plant: replay ``(x_last, u_last)``
    under each hypothesis of ``f_batch`` (B, 6) and rank the predictions
    by their distance to ``x_obs``.  Returns (winning lane, (B,)
    distances); a NaN distance wins, the first NaN first, as
    ``jnp.argmin`` does."""
    x_pred = predict_next_states(model, x_last, u_last, dt, f_batch)
    err = torch.linalg.norm(x_pred - x_obs, dim=-1)
    return first_argmin(err), err


class _Models(nn.Module):
    """RobotModels held as buffers (``{name}_{field}``), so that ``.to``
    moves them, and handed out per dtype."""

    def __init__(self, **models: RobotModel):
        super().__init__()
        self._names = tuple(models)
        for name, m in models.items():
            for f in FIELDS:
                self.register_buffer(f"{name}_{f}", getattr(m, f))
        self._cache = {}

    def _apply(self, fn, recurse=True):
        self._cache = {}  # buffers move: rebuild the models
        return super()._apply(fn, recurse)

    def models(self, dtype: torch.dtype):
        """The RobotModels in ``dtype``, in the constructor's order."""
        if dtype not in self._cache:
            self._cache[dtype] = tuple(
                RobotModel(**{f: getattr(self, f"{n}_{f}").to(dtype) for f in FIELDS})
                for n in self._names
            )
        return self._cache[dtype]


class ReadableSampledTick(_Models):
    """``tick(x_obs, x_last, u_last, goals, X_warm, U_warm, f_batch,
    normals=None) -> (SampledTickResult, ee_pos)``, the same contract as
    ``fused_tick.SampledTick``, on ``batch_solve_fn`` (default: the
    readable solver).  ``sqp_iters`` is the winner's count as the solver
    reports it (the readable solver counts the iterations run).

    ``f_batch`` and the result's ``f_batch`` are this rank's block of
    ``mesh`` (default: one rank, all B lanes); everything else is the same
    on every rank.  Without ``normals`` (the full (B, 6) draws) the
    resampling draws them from ``generator``, which every rank seeds
    alike."""

    def __init__(
        self,
        model: RobotModel,
        cost_cfg: CostConfig,
        sqp_cfg: SQPConfig,
        sample_cfg: SampleConfig,
        dt: float,
        generator: Optional[torch.Generator] = None,
        batch_solve_fn: Optional[Callable] = None,
        mesh: Optional[LaneMesh] = None,
    ):
        sqp_mod.require_qp_backend(sqp_cfg)
        super().__init__(ctl=model)
        self.cost_cfg, self.sqp_cfg = cost_cfg, sqp_cfg
        self.sample_cfg, self.dt = sample_cfg, dt
        self.generator = generator
        self.batch_solve_fn = batch_solve_fn
        self.mesh = mesh or single_rank_mesh()

    def forward(self, x_obs, x_last, u_last, goals, X_warm, U_warm, f_batch, normals=None):
        (model,) = self.models(x_obs.dtype)
        b = f_batch.shape[0]
        if normals is None:
            if self.generator is None:
                raise ValueError("tick called without normals and without a generator")
            normals = torch.randn((b * self.mesh.size, 6), generator=self.generator,
                                  device=x_obs.device, dtype=x_obs.dtype)
        X0 = torch.cat([x_obs[None], X_warm[1:]])  # the measured state pinned
        lanes = lambda t: t[None].expand((b,) + t.shape)
        # The default solver takes the model already on the inputs' device.
        solve = self.batch_solve_fn or sqp_mod.batch_solve_fn(
            model, self.cost_cfg, self.sqp_cfg, self.dt)
        res = solve(lanes(x_obs), lanes(goals), lanes(X0), lanes(U_warm), f_batch)

        _, err = readable_consensus(model, x_last, u_last, x_obs, self.dt, f_batch)
        w = cross_rank_consensus(self.mesh, err, res.X, res.U, f_batch, res.stats.iterations)
        return SampledTickResult(
            u=w.U_best[0],
            best_idx=w.best,
            X_best=w.X_best,
            U_best=w.U_best,
            f_batch=resample_lanes(self.mesh, normals, f_batch, w.best, w.f_est,
                                   self.sample_cfg),
            f_est=w.f_est,
            sqp_iters=w.sqp_iters,
        ), ee_pos(model, x_obs[: model.nq])


class ReadableLoopTick(nn.Module):
    """``tick(carry, draws=None) -> (carry, SampledTrace)``: the closed-loop
    tick of ``make_loop_tick(fused=False)``.

    The controller tick is a :class:`ReadableSampledTick`; the plant is
    ``sim/readable_plant.py``'s RK4 on the plant model (``plant_model`` or
    the controller's, perturbed by ``plant_cfg``) with friction, actuation
    noise and joint stops.  Without ``draws`` the tick draws its random
    numbers from ``generator``, which must live on the carry's device.

    With a ``mesh`` of several ranks the carry's ``f_batch`` is this rank's
    block and the rest is the same on every rank: the controller tick
    chooses the winner over the ranks, and every rank steps the same plant
    on the same draws.  A subclass swaps the controller and the plant
    through :meth:`controller`, :meth:`plant_models` and
    :meth:`step_plant`.
    """

    def __init__(
        self,
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
        generator: Optional[torch.Generator] = None,
        mesh: Optional[LaneMesh] = None,
    ):
        super().__init__()
        ref_traj = torch.as_tensor(ref_traj)
        if ref_traj.shape[0] < mpc_cfg.N:
            raise ValueError("reference trajectory shorter than the horizon")
        self.plant_cfg = plant_cfg or PlantConfig(substeps=mpc_cfg.sim_substeps)
        self.sampled = self.controller(
            model, cost_cfg, sqp_cfg, sample_cfg, mpc_cfg.dt, batch_solve_fn,
            mesh or single_rank_mesh(),
        )
        self.plant = self.plant_models(model, perturb_model(
            model if plant_model is None else plant_model, self.plant_cfg))
        self.sample_cfg = sample_cfg
        self.N, self.dt = mpc_cfg.N, mpc_cfg.dt
        self.f_true_walk = f_true_walk
        self.generator = generator
        self.register_buffer("ref_traj", ref_traj)

    def controller(self, model, cost_cfg, sqp_cfg, sample_cfg, dt, batch_solve_fn, mesh):
        """The controller tick: a :class:`ReadableSampledTick`."""
        return ReadableSampledTick(model, cost_cfg, sqp_cfg, sample_cfg, dt,
                                   batch_solve_fn=batch_solve_fn, mesh=mesh)

    def plant_models(self, model: RobotModel, plant: RobotModel) -> nn.Module:
        """The models :meth:`step_plant` reads, as a module (so that ``.to``
        moves them): the perturbed plant."""
        return _Models(plant=plant)

    def step_plant(self, x, u, f_true, noise):
        """The ground-truth plant step under the true wrench."""
        cfg = self.plant_cfg
        (plant,) = self.plant.models(x.dtype)
        return plant_step(
            plant, x, u, self.dt, wrench_world=f_true, substeps=cfg.substeps,
            friction=plant_friction(cfg), noise=noise,
            velocity_saturation=cfg.velocity_saturation,
        )

    @staticmethod
    def tracking_error(eep, goal):
        return torch.linalg.norm(eep - goal)

    def forward(self, carry: SampledLoopCarry, draws: Optional[TickDraws] = None):
        x = carry.x
        if draws is None:
            draws = draw_tick(self.generator, self.sample_cfg, self.plant_cfg,
                              x.device, x.dtype)
        goals = reference_window(self.ref_traj, carry.ref_offset, self.N).to(x.dtype)
        out, eep = self.sampled(
            x, carry.x_last, carry.u_last, goals, carry.X_best, carry.U_best,
            carry.f_batch, normals=draws.resample,
        )

        cfg = self.plant_cfg
        noise = cfg.torque_noise_std * draws.plant if cfg.torque_noise_std else None
        x_next = self.step_plant(x, out.u, carry.f_true, noise)

        f_true = walk_true_wrench(carry.f_true, draws.walk, carry.ref_offset, self.f_true_walk)

        trace = SampledTrace(
            tracking_error=self.tracking_error(eep, goals[0]),
            ee_pos=eep,
            ee_ref=goals[0],
            q=x[:6],
            u=out.u,
            best_idx=out.best_idx,
            f_est=out.f_est,
            f_true=carry.f_true,
            x=x,
        )
        new_carry = SampledLoopCarry(
            x=x_next,
            x_last=x,
            u_last=out.u,
            X_best=out.X_best,
            U_best=out.U_best,
            f_batch=out.f_batch,
            f_true=f_true,
            ref_offset=carry.ref_offset + 1,
        )
        return new_carry, trace

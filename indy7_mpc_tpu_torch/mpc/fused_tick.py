"""The sampled-MPC control ticks on two kernels (port of ``mpc/fused_tick.py``).

:class:`FusedLoopTick`, the closed-loop tick: slice the reference window,
broadcast the state and the warm start to the B lanes, run the batched SQP
solve (K1), run the tick epilogue (K2: consensus, argmin, winner gather,
plant step, trace FK), gather the winning lane's trajectory, resample the
wrench hypotheses and random-walk the true wrench.

:class:`SampledTick`, the host-driven controller tick behind
``mpc.sampled.sampled_tick`` and ``runtime.SampledController``: the same
solve, then consensus on an observed state (K2 with its plant step
skipped), winner gather and resampling; no plant.

On CUDA both kernels run in float32; on the CPU their plain versions run
in the inputs' dtype.  Neither tick reads a device value on the host.
:class:`SampledTick` takes a lane mesh (``lane_mesh.py``), as the readable
host tick does: its lanes are then this rank's block and the winner is
chosen over every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import (
    CostConfig, MPCConfig, PlantConfig, SampleConfig, SQPConfig,
)
from ..models.robot import RobotModel
from ..ops.kernels.sqp_kernel import require_kernel_config, sqp_solve
from ..ops.kernels.tick_kernel import tick_epilogue
from ..ops.lane_rbd import STATIC_FIELDS, StaticModel, static_model
from ..sim.plant import perturb_model
from .lane_mesh import LaneMesh, cross_rank_consensus, resample_lanes, single_rank_mesh
from .sampled import (
    SampledLoopCarry, SampledTickResult, SampledTrace, TickDraws, draw_tick,
    resample_wrench_batch,
)


def reference_window(ref_traj, offset, N: int):
    """``ref_traj[offset : offset + N]`` with the start clamped to
    ``[0, len - N]``, as ``jax.lax.dynamic_slice_in_dim`` does.  ``offset``
    is a 0-d integer tensor (the window is gathered on the device) or a
    Python int (the window is a view)."""
    if isinstance(offset, int):
        start = min(max(offset, 0), ref_traj.shape[0] - N)
        return ref_traj[start:start + N]
    start = torch.clamp(offset, 0, ref_traj.shape[0] - N)
    return ref_traj.index_select(
        0, start + torch.arange(N, device=ref_traj.device)
    )


def broadcast_solve(smc, cost_cfg, sqp_cfg, dt, xk, goals, X_warm, U_warm, fb_T):
    """K1 on B lanes that share one warm start, with the measured state
    ``xk`` pinned as its first knot; the lanes differ only in their wrench
    column of ``fb_T`` (6, B).  Everything is cast to ``xk``'s dtype.
    Returns ``sqp_solve``'s (X, U, rho, alphas, steps), lane-major."""
    N, B, kdt = goals.shape[0], fb_T.shape[1], xk.dtype
    X0 = X_warm.to(kdt).clone()
    X0[0] = xk
    return sqp_solve(
        smc, cost_cfg, sqp_cfg, dt,
        xk[:, None].expand(12, B).contiguous(),
        goals.to(kdt)[:, :, None].expand(N, 3, B).contiguous(),
        X0[:, :, None].expand(N, 12, B).contiguous(),
        U_warm.to(kdt)[:, :, None].expand(N - 1, 6, B).contiguous(),
        wrench=fb_T,
    )


def walk_true_wrench(f_true, walk, ref_offset, enabled: bool):
    """The true disturbance's random walk: every 200 reference steps (on
    ``ref_offset``, a 0-d integer tensor) its force moves by ``walk`` (3,),
    clamped to +-20 N; the torque is kept."""
    walked = f_true.clone()
    walked[:3] = torch.clamp(f_true[:3] + walk, -20.0, 20.0)
    return torch.where((ref_offset % 200 == 0) & enabled, walked, f_true)


def consensus_args(x_obs, x_last, u_last, f_batch_T, U0_T):
    """``tick_epilogue``'s arguments after ``(smc, smc, None, dt)`` for the
    host-driven tick's consensus: ``x_obs`` as K2's current state, a zero
    true wrench, no actuation noise.  The tick reads no plant state, so it
    calls K2 with ``plant=False``, which skips the plant step."""
    return (x_obs, x_last.contiguous(), u_last.contiguous(), f_batch_T, U0_T,
            torch.zeros(6, dtype=x_obs.dtype, device=x_obs.device), None)


class _StaticModels(nn.Module):
    """StaticModels held as buffers (``{name}_{field}``), so that ``.to``
    moves them, and handed out per dtype, built once."""

    def __init__(self, **models: StaticModel):
        super().__init__()
        self._names = tuple(models)
        for name, sm in models.items():
            for f in STATIC_FIELDS:
                self.register_buffer(f"{name}_{f}", getattr(sm, f))
        self._static = {}

    def _apply(self, fn, recurse=True):
        self._static = {}  # buffers move: rebuild the static models
        return super()._apply(fn, recurse)

    def static_models(self, dtype: torch.dtype):
        """The StaticModels in ``dtype``, in the constructor's order."""
        if dtype not in self._static:
            self._static[dtype] = tuple(
                StaticModel(
                    **{f: getattr(self, f"{n}_{f}").to(dtype) for f in STATIC_FIELDS}
                )
                for n in self._names
            )
        return self._static[dtype]


class FusedLoopTick(_StaticModels):
    """``tick(carry, draws=None) -> (carry, SampledTrace)``.

    Buffers: the reference trajectory and the controller and plant static
    models (``smc_*``, ``smp_*``).  Without ``draws`` the tick draws its
    random numbers from ``generator``, which must live on the carry's
    device.
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
        plant_cfg: Optional[PlantConfig] = None,
        plant_model: Optional[RobotModel] = None,
        generator: Optional[torch.Generator] = None,
    ):
        require_kernel_config(cost_cfg, sqp_cfg)
        ref_traj = torch.as_tensor(ref_traj)
        if ref_traj.shape[0] < mpc_cfg.N:
            raise ValueError("reference trajectory shorter than the horizon")
        plant_cfg = plant_cfg or PlantConfig(substeps=mpc_cfg.sim_substeps)
        plant = perturb_model(model if plant_model is None else plant_model, plant_cfg)
        super().__init__(smc=static_model(model), smp=static_model(plant))
        self.cost_cfg, self.sqp_cfg = cost_cfg, sqp_cfg
        self.sample_cfg = sample_cfg
        self.N, self.dt = mpc_cfg.N, mpc_cfg.dt
        self.f_true_walk = f_true_walk
        self.plant_cfg = plant_cfg
        self.generator = generator
        self.register_buffer("ref_traj", ref_traj)

    def forward(self, carry: SampledLoopCarry, draws: Optional[TickDraws] = None):
        x = carry.x
        dtype, device = x.dtype, x.device
        kdt = torch.float32 if device.type == "cuda" else dtype
        smc, smp = self.static_models(kdt)
        if draws is None:
            draws = draw_tick(self.generator, self.sample_cfg, self.plant_cfg, device, dtype)
        goals = reference_window(self.ref_traj, carry.ref_offset, self.N).to(dtype)

        # ---- K1: the batched solve, lanes broadcast from one warm start ----
        xk = x.to(kdt)
        fb_T = carry.f_batch.to(kdt).T.contiguous()
        X, U, _rho, _alphas, _steps = broadcast_solve(
            smc, self.cost_cfg, self.sqp_cfg, self.dt, xk, goals,
            carry.X_best, carry.U_best, fb_T,
        )

        # ---- K2: consensus, winner, plant, trace FK ----
        noise = None
        if self.plant_cfg.torque_noise_std:
            noise = (self.plant_cfg.torque_noise_std * draws.plant).to(kdt).contiguous()
        ep = tick_epilogue(
            smc, smp, self.plant_cfg, self.dt, xk,
            carry.x_last.to(kdt).contiguous(), carry.u_last.to(kdt).contiguous(),
            fb_T, U[0], carry.f_true.to(kdt).contiguous(), noise,
        )

        # Winner trajectory for the next warm start (device index, no sync).
        idx = ep.best.reshape(1)
        X_best = X.index_select(2, idx)[:, :, 0].to(carry.X_best.dtype)
        U_best = U.index_select(2, idx)[:, :, 0].to(carry.U_best.dtype)
        f_new = resample_wrench_batch(
            draws.resample, carry.f_batch, ep.best, self.sample_cfg
        )

        f_true = walk_true_wrench(carry.f_true, draws.walk, carry.ref_offset, self.f_true_walk)

        eep = ep.eep.to(dtype)
        u = ep.u.to(dtype)
        trace = SampledTrace(
            tracking_error=torch.sqrt(((eep - goals[0]) ** 2).sum()),
            ee_pos=eep,
            ee_ref=goals[0],
            q=x[:6],
            u=u,
            best_idx=ep.best,
            f_est=ep.f_est.to(dtype),
            f_true=carry.f_true,
            x=x,
        )
        new_carry = SampledLoopCarry(
            x=ep.x_next.to(dtype),
            x_last=x,
            u_last=u.to(carry.u_last.dtype),
            X_best=X_best,
            U_best=U_best,
            f_batch=f_new,
            f_true=f_true,
            ref_offset=carry.ref_offset + 1,
        )
        return new_carry, trace


class SampledTick(_StaticModels):
    """``tick(x_obs, x_last, u_last, goals, X_warm, U_warm, f_batch,
    normals=None) -> (SampledTickResult, ee_pos)``: one host-driven
    controller tick (``mpc.sampled.sampled_tick``).

    K1 solves the lanes from the shared warm start.  Consensus is K2
    (:func:`consensus_args`; the TPU package does the same on its
    accelerator): it replays ``(x_last, u_last)`` under each hypothesis
    and scores each prediction by its distance to ``x_obs``; its plant
    step is skipped (``plant=False``).  The lane nearest ``x_obs`` wins,
    the first NaN first (``lane_mesh.cross_rank_consensus``).  ``ee_pos``
    (3,) is the end-effector position of ``x_obs``, from K2's trace FK.

    ``f_batch`` and the result's ``f_batch`` are this rank's block of
    ``mesh`` (default: one rank, all B lanes): K1 and K2 then run on the
    block and the winner is chosen over the ranks.  Without ``normals``
    (the full (B, 6) draws) the resampling draws them from ``generator``,
    which every rank seeds alike.
    """

    def __init__(
        self,
        model: RobotModel,
        cost_cfg: CostConfig,
        sqp_cfg: SQPConfig,
        sample_cfg: SampleConfig,
        dt: float,
        generator: Optional[torch.Generator] = None,
        mesh: Optional[LaneMesh] = None,
    ):
        require_kernel_config(cost_cfg, sqp_cfg)
        super().__init__(smc=static_model(model))
        self.cost_cfg, self.sqp_cfg = cost_cfg, sqp_cfg
        self.sample_cfg, self.dt = sample_cfg, dt
        self.generator = generator
        self.mesh = mesh or single_rank_mesh()

    def forward(self, x_obs, x_last, u_last, goals, X_warm, U_warm, f_batch, normals=None):
        dtype, device = x_obs.dtype, x_obs.device
        kdt = torch.float32 if device.type == "cuda" else dtype
        (smc,) = self.static_models(kdt)
        if normals is None:
            if self.generator is None:
                raise ValueError("tick called without normals and without a generator")
            normals = torch.randn((f_batch.shape[0] * self.mesh.size, 6),
                                  generator=self.generator, device=device, dtype=dtype)
        xk = x_obs.to(kdt)
        fb_T = f_batch.to(kdt).T.contiguous()
        X, U, _rho, alphas, _steps = broadcast_solve(
            smc, self.cost_cfg, self.sqp_cfg, self.dt, xk, goals, X_warm, U_warm, fb_T
        )
        ep = tick_epilogue(smc, smc, None, self.dt, *consensus_args(
            xk, x_last.to(kdt), u_last.to(kdt), fb_T, U[0]), plant=False)
        w = cross_rank_consensus(self.mesh, ep.err, X.permute(2, 0, 1), U.permute(2, 0, 1),
                                 f_batch, (alphas > 0).sum(0))
        U_best = w.U_best.to(dtype)
        return SampledTickResult(
            u=U_best[0],
            best_idx=w.best,
            X_best=w.X_best.to(dtype),
            U_best=U_best,
            f_batch=resample_lanes(self.mesh, normals, f_batch, w.best, w.f_est,
                                   self.sample_cfg),
            f_est=w.f_est,
            sqp_iters=w.sqp_iters,
        ), ep.eep.to(dtype)


def make_fused_loop_tick(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    mpc_cfg: MPCConfig,
    sample_cfg: SampleConfig,
    ref_traj,
    f_true_walk: bool = True,
    plant_cfg: Optional[PlantConfig] = None,
    plant_model: Optional[RobotModel] = None,
    generator: Optional[torch.Generator] = None,
) -> FusedLoopTick:
    """The two-kernel tick on the device of ``ref_traj`` (move it with
    ``.to``)."""
    ref = torch.as_tensor(ref_traj)
    return FusedLoopTick(
        model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, ref,
        f_true_walk=f_true_walk, plant_cfg=plant_cfg, plant_model=plant_model,
        generator=generator,
    ).to(ref.device)

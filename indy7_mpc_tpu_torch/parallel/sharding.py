"""Lane-axis sharding over the ranks of a process group (port of
``indy7_mpc_tpu/parallel/sharding.py``).

The TPU package shards the hypothesis (lane) axis over a 1-D device mesh
and lets XLA insert the collectives.  Here the mesh is one process per
rank on one device each (``mpc/lane_mesh.py::LaneMesh``, over
``torch.distributed``).  A rank holds a contiguous block of the B lanes
and solves it with kernel K1 in one launch, the counterpart of
``_shard_mapped_kernel_solve``; the lanes are independent, so the solve
needs no communication.

As the TPU package's sharded loop scans the same tick program as its
single-device loop, the sharded ticks here are the single-process ticks
given the mesh: ``SampledTick`` (K1 and K2's consensus on the block) and
``ReadableSampledTick`` choose the winner over the ranks
(``lane_mesh.cross_rank_consensus``, two all-reduces) and resample on
global lane indices.  Everything else is replicated: every rank holds the
same state, draws the same numbers from a generator seeded alike (the
full (B, 6) resampling normals, of which it keeps its block) and steps
the same plant, so the ranks stay equal without more traffic.  The one
sharded-only piece is the kernel loop's plant (:class:`KernelLanesLoopTick`):
the single-process loop fuses it into K2's B-lane call, which here scores
only the rank's block, so the plant is K2 again at B = 1.

The kernels are ctypes calls on raw pointers, so the port uses a plain
process group and plain tensors, not DTensor.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..config import (
    CostConfig, MPCConfig, PlantConfig, SampleConfig, SQPConfig,
)
from ..models.robot import RobotModel
from ..mpc.fused_tick import SampledTick, _StaticModels
from ..mpc.lane_mesh import LaneMesh
from ..mpc.readable_tick import ReadableLoopTick, ReadableSampledTick
from ..mpc.sampled import SampledLoopCarry, SampledTrace, TickDraws
from ..ops.kernels.sqp_kernel import require_kernel_config
from ..ops.lane_rbd import static_model
from ..sim.kernel_plant import kernel_plant_step
from ..solvers import sqp as sqp_mod

LANE_AXIS = "lanes"
BACKENDS = ("kernel", "readable", "auto")


def shard_lanes(mesh: LaneMesh, tree, layout=LANE_AXIS):
    """This rank's part of ``tree`` (tensors, arrays, tuples and named
    tuples of them), copied to the mesh's device: the rank's lane block of
    each leaf's leading axis.  ``layout`` is ``LANE_AXIS`` (every leaf
    lane-sharded), None (every leaf replicated: whole) or a tree of those
    with the structure of ``tree``, as :func:`make_sharded_sampled_loop`'s
    carry layout."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        parts = layout if isinstance(layout, (tuple, list)) else [layout] * len(tree)
        out = [shard_lanes(mesh, t, p) for t, p in zip(tree, parts)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    t = torch.as_tensor(tree)
    if layout == LANE_AXIS:
        t = t[mesh.lanes(t.shape[0])]
    return t.to(mesh.device, copy=True)


def resolve_backend(backend: str, mesh: LaneMesh, cost_cfg: CostConfig,
                    sqp_cfg: SQPConfig) -> str:
    """``"auto"`` is ``"kernel"`` inside K1's coverage, else ``"readable"``
    (with ``solvers.select``'s warning on a card); ``"kernel"`` outside the
    coverage and an unknown name raise ValueError."""
    from ..solvers.select import _warn_slow_path_on_cuda, kernel_supports

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    sqp_mod.require_qp_backend(sqp_cfg)
    if backend == "auto":
        if kernel_supports(cost_cfg, sqp_cfg):
            return "kernel"
        if mesh.device.type == "cuda":
            _warn_slow_path_on_cuda(cost_cfg, sqp_cfg)
        return "readable"
    if backend == "kernel":
        require_kernel_config(cost_cfg, sqp_cfg)
    return backend


def make_sharded_batch_solve(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    mesh: LaneMesh,
    backend: str = "auto",
) -> Callable:
    """``fn(xs_b, goals_b, X_b, U_b, wrench_b) -> SQPResult`` on this
    rank's lane block (B-major, the inputs of ``solvers/sqp_cuda``), with
    no communication: ``"kernel"`` is one K1 launch (its plain version for
    CPU tensors), ``"readable"`` the readable solver.  The result is the
    rank's block; :meth:`LaneMesh.gather` assembles it whole."""
    backend = resolve_backend(backend, mesh, cost_cfg, sqp_cfg)
    model = model.to(device=mesh.device)
    if backend == "kernel":
        from ..solvers import sqp_cuda

        return sqp_cuda.batch_solve_fn(model, cost_cfg, sqp_cfg, dt)
    return sqp_mod.batch_solve_fn(model, cost_cfg, sqp_cfg, dt)


def consensus_bytes(B: int, N: int) -> int:
    """Bytes of the two float32 buffers ``cross_rank_consensus``
    all-reduces on the card: the (B,) errors and the winner's X (N, 12),
    U (N-1, 6), wrench and iteration count."""
    return 4 * (B + N * 12 + (N - 1) * 6 + 6 + 1)


def make_sharded_sampled_tick(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    sample_cfg: SampleConfig,
    dt: float,
    mesh: LaneMesh,
    backend: str = "auto",
    generator: Optional[torch.Generator] = None,
):
    """The host-driven tick with the hypothesis batch sharded over the
    mesh, on the mesh's device: ``tick(x_obs, x_last, u_last, goals,
    X_warm, U_warm, f_batch, normals=None) -> (SampledTickResult,
    ee_pos)``, where ``f_batch`` and the result's ``f_batch`` are this
    rank's (B/R, 6) block, ``normals`` the full (B, 6) draws (else
    ``generator``'s, which every rank seeds alike) and everything else is
    replicated.  ``backend`` chooses the solver and the consensus
    together: ``"kernel"`` (``SampledTick``: K1 and K2 on the rank's
    block), ``"readable"`` (``ReadableSampledTick``: the readable solver
    and consensus) or ``"auto"`` (:func:`resolve_backend`)."""
    backend = resolve_backend(backend, mesh, cost_cfg, sqp_cfg)
    cls = SampledTick if backend == "kernel" else ReadableSampledTick
    return cls(model, cost_cfg, sqp_cfg, sample_cfg, dt, generator, mesh=mesh).to(mesh.device)


class KernelLanesLoopTick(ReadableLoopTick):
    """``ReadableLoopTick`` on the kernels, for a rank's block of lanes: the
    controller tick is ``SampledTick`` on the mesh (K1, and K2 as the
    block's consensus) and the ground-truth plant step is K2 at B = 1
    (``sim/kernel_plant.py``) on the replicated state.  On CUDA in
    float32; on the CPU the plain versions in the carry's dtype."""

    def controller(self, model, cost_cfg, sqp_cfg, sample_cfg, dt, batch_solve_fn, mesh):
        return SampledTick(model, cost_cfg, sqp_cfg, sample_cfg, dt, mesh=mesh)

    def plant_models(self, model, plant):
        return _StaticModels(smc=static_model(model), smp=static_model(plant))

    def step_plant(self, x, u, f_true, noise):
        kdt = torch.float32 if x.device.type == "cuda" else x.dtype
        smc, smp = self.plant.static_models(kdt)
        x_next, _ = kernel_plant_step(
            smc, smp, self.plant_cfg, self.dt, x.to(kdt), u.to(kdt), f_true.to(kdt),
            None if noise is None else noise.to(kdt),
        )
        return x_next.to(x.dtype)

    @staticmethod
    def tracking_error(eep, goal):
        return torch.sqrt(((eep - goal) ** 2).sum())  # as FusedLoopTick's trace


def make_sharded_sampled_loop(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    mpc_cfg: MPCConfig,
    sample_cfg: SampleConfig,
    mesh: LaneMesh,
    ref_traj,
    chunk: int,
    backend: str = "auto",
    f_true_walk: bool = True,
    plant_cfg: Optional[PlantConfig] = None,
    generator: Optional[torch.Generator] = None,
):
    """The closed loop (controller tick, ground-truth plant step, reference
    advance) with the hypothesis batch sharded over the mesh, ``chunk``
    ticks a call, on the mesh's device.

    Returns ``(loop, carry_layout)``: ``loop(carry, draws=None) -> (carry,
    trace)`` runs ``chunk`` ticks (``draws``: ``chunk`` full-tick
    ``TickDraws``, else ``generator``'s, which every rank seeds alike) and
    stacks their traces; ``carry_layout`` marks the carry's lane-sharded
    field (``f_batch``: ``LANE_AXIS``) and the replicated ones (None).
    Place a carry with ``shard_lanes(mesh, carry, carry_layout)``; it then
    stays on the device.  ``backend`` is :func:`make_sharded_sampled_tick`'s:
    the tick is :class:`KernelLanesLoopTick` on ``"kernel"`` and
    ``ReadableLoopTick`` on ``"readable"``, the plant ``model`` perturbed
    by ``plant_cfg``."""
    backend = resolve_backend(backend, mesh, cost_cfg, sqp_cfg)
    cls = KernelLanesLoopTick if backend == "kernel" else ReadableLoopTick
    tick = cls(model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, ref_traj,
               f_true_walk=f_true_walk, plant_cfg=plant_cfg, generator=generator,
               mesh=mesh).to(mesh.device)

    def loop(carry: SampledLoopCarry, draws: Optional[Sequence[TickDraws]] = None):
        traces = []
        for t in range(chunk):
            carry, trace = tick(carry, None if draws is None else draws[t])
            traces.append(trace)
        return carry, SampledTrace(*(torch.stack(f) for f in zip(*traces)))

    carry_layout = SampledLoopCarry(*(None,) * len(SampledLoopCarry._fields))._replace(
        f_batch=LANE_AXIS)
    return loop, carry_layout

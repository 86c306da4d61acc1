"""Closed-loop MPC: the sampled controller's ticks and loop, and the
single-lane loops.

  * ``run_sampled_mpc`` — B wrench hypotheses against the plant, on the
    two-kernel ``FusedLoopTick``;
  * ``sampled_tick`` / ``fused_tick.SampledTick`` — the host-driven
    controller tick that ``runtime.SampledController`` calls;
  * ``run_mpc`` (point to goal) and ``run_tracking_mpc`` (fig-8) — one
    hypothesis, the SQP kernel at B = 1.
"""
from . import reference
from .fused_tick import FusedLoopTick, SampledTick, make_fused_loop_tick
from .point_to_goal import MPCCarry, MPCTrace, run_mpc
from .sampled import (
    SampledLoopCarry,
    SampledTickResult,
    SampledTrace,
    TickDraws,
    find_best_lane,
    init_loop_carry,
    init_wrench_batch,
    resample_wrench_batch,
    run_sampled_mpc,
    sampled_tick,
)
from .tracking import TrackingCarry, TrackingTrace, run_tracking_mpc

__all__ = [
    "FusedLoopTick",
    "MPCCarry",
    "MPCTrace",
    "SampledLoopCarry",
    "SampledTick",
    "SampledTickResult",
    "SampledTrace",
    "TickDraws",
    "TrackingCarry",
    "TrackingTrace",
    "find_best_lane",
    "init_loop_carry",
    "init_wrench_batch",
    "make_fused_loop_tick",
    "reference",
    "resample_wrench_batch",
    "run_mpc",
    "run_sampled_mpc",
    "run_tracking_mpc",
    "sampled_tick",
]

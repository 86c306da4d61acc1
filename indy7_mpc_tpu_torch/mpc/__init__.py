"""Closed-loop MPC: the sampled controller's ticks and loop, and the
single-lane loops.

  * ``run_sampled_mpc`` — B wrench hypotheses against the plant, on the
    tick ``make_loop_tick`` selects: the two-kernel ``FusedLoopTick``, or
    the readable ``ReadableLoopTick`` (``fused=False``, an injected
    solver, or a configuration outside the SQP kernel's coverage);
  * ``sampled_tick`` / ``make_sampled_tick`` — the host-driven controller
    tick that ``runtime.SampledController`` calls (``SampledTick`` or
    ``ReadableSampledTick``, by the same choice);
  * ``run_mpc`` (point to goal) and ``run_tracking_mpc`` (fig-8) — one
    hypothesis, the SQP kernel at B = 1.
"""
from . import reference
from .fused_tick import FusedLoopTick, SampledTick, make_fused_loop_tick
from .point_to_goal import MPCCarry, MPCTrace, run_mpc
from .readable_tick import ReadableLoopTick, ReadableSampledTick
from .sampled import (
    SampledLoopCarry,
    SampledTickResult,
    SampledTrace,
    TickDraws,
    draw_tick,
    find_best_lane,
    init_loop_carry,
    init_wrench_batch,
    make_loop_tick,
    make_sampled_tick,
    resample_wrench_batch,
    run_sampled_mpc,
    sampled_tick,
)
from .tracking import TrackingCarry, TrackingTrace, run_tracking_mpc

__all__ = [
    "FusedLoopTick",
    "MPCCarry",
    "MPCTrace",
    "ReadableLoopTick",
    "ReadableSampledTick",
    "SampledLoopCarry",
    "SampledTick",
    "SampledTickResult",
    "SampledTrace",
    "TickDraws",
    "TrackingCarry",
    "TrackingTrace",
    "draw_tick",
    "find_best_lane",
    "init_loop_carry",
    "init_wrench_batch",
    "make_fused_loop_tick",
    "make_loop_tick",
    "make_sampled_tick",
    "reference",
    "resample_wrench_batch",
    "run_mpc",
    "run_sampled_mpc",
    "run_tracking_mpc",
    "sampled_tick",
]

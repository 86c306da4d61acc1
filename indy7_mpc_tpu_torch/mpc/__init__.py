"""Sampled MPC closed loop."""
from . import reference
from .fused_tick import FusedLoopTick, make_fused_loop_tick
from .sampled import (
    SampledLoopCarry,
    SampledTrace,
    TickDraws,
    init_loop_carry,
    init_wrench_batch,
    resample_wrench_batch,
    run_sampled_mpc,
)

__all__ = [
    "FusedLoopTick",
    "SampledLoopCarry",
    "SampledTrace",
    "TickDraws",
    "init_loop_carry",
    "init_wrench_batch",
    "make_fused_loop_tick",
    "reference",
    "resample_wrench_batch",
    "run_sampled_mpc",
]

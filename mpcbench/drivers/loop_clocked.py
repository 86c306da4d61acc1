"""The ``loop`` driver's closed loop, with K1's stage clocks on in a
traced run.

Untraced, this is ``drivers/loop.py``'s run and nothing else: the
end-to-end numbers are the ``loop`` mix's.  Traced, it first switches the
program's tracing on (``indy7_mpc_tpu_torch.tracing.enable``) and zeroes
K1's clocks with a read, runs the loop, and hands K1's cycles by stage
(``tracing.k1_stage_cycles()``: every K1 launch of the run, the warm-up,
the window and the traced chunks) to the readers as
``values["k1_stage_cycles"]``.  A program without K1's clocks, or without
a slot the readers ask for, gives them nothing to read.

Mix keys: those of ``loop``.
"""
from __future__ import annotations

from ..harness import Context, Run
from . import loop


def run(ctx: Context) -> Run:
    if not ctx.trace:
        return loop.run(ctx)
    from indy7_mpc_tpu_torch import tracing

    tracing.enable()
    try:
        tracing.k1_stage_cycles(ctx.device)
        out = loop.run(ctx)
        out.values["k1_stage_cycles"] = tracing.k1_stage_cycles(ctx.device)
    finally:
        tracing.enable(False)
    return out

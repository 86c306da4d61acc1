"""K1's stage clocks as device time: a slot's share of K1's cycles
(``values["k1_stage_cycles"]``, which the ``loop_clocked`` driver reads
from the program's ``tracing.k1_stage_cycles()``; each slot summed over
every block timed) times K1's device time a launch in the traced window
(kernels named ``sqp_kernel``)."""

KERNEL = "sqp_kernel"
# The slot that only a program with the segment hand-off clock has.
HANDOFF = "handoff"


def slot_us(run, slot: str):
    """µs a launch of K1 in ``slot``: ``slot / total`` of the cycles times
    K1's device µs a launch.  None without a trace, without the cycles,
    without the hand-off slot or without a K1 launch traced."""
    cycles = run.values.get("k1_stage_cycles")
    if run.trace is None or not cycles or HANDOFF not in cycles or cycles["total"] <= 0:
        return None
    seconds, launches = run.trace.op_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    return cycles[slot] / cycles["total"] * seconds / launches * 1e6

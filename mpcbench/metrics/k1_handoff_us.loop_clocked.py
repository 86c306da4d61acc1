"""K1's wait at its segment hand-offs, in µs a launch: the blocks' cycles
at the cluster barriers between segments of the Riccati sweep and the
rollout (the program's ``handoff`` clock) over their whole time, times
K1's device time a launch in the traced window (``stage_clocks.slot_us``).
At C blocks a lane each waits while the others sweep or roll out their
segments; with one block a lane it reads 0."""
from mpcbench import stage_clocks


def read(run, cell):
    return stage_clocks.slot_us(run, "handoff")

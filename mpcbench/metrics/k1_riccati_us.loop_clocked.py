"""K1's Riccati sweep (stage 2), in µs a launch: its share of the blocks'
cycles (the program's ``riccati`` clock, the hand-offs inside it
included) times K1's device time a launch in the traced window
(``stage_clocks.slot_us``)."""
from mpcbench import stage_clocks


def read(run, cell):
    return stage_clocks.slot_us(run, "riccati")

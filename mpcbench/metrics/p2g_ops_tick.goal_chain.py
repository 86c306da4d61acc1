"""Device operations a tick in a point-to-goal cell's traced window: every
kernel and copy the device ran in the window, over the window's ticks.
Each scalar operation of the tick's forward kinematics is one of them."""


def read(run, cell):
    if run.trace is None or not run.trace.ops or not run.trace.ticks:
        return None
    return len(run.trace.ops) / run.trace.ticks

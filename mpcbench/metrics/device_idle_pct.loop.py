"""The share of a loop cell's traced window in which no operation ran on
the device, in percent: 100 minus the union of the device's operations
over the window's wall time."""


def read(run, cell):
    if run.trace is None or not run.trace.ops or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)

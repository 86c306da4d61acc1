"""Median device microseconds of a controller tick in the traced window:
the operations (K1, K2, copies and the tick's small kernels) that start
inside a tick's ``on_state`` span."""
import statistics


def device_us(trace):
    """Device µs of each traced tick, in order."""
    return [sum(d for _, _, d in trace.ops_in(a, b))
            for a, b in trace.spans_named("on_state")]


def read(run, cell):
    if run.trace is None or not run.trace.ops:
        return None
    per_tick = device_us(run.trace)
    return statistics.median(per_tick) if per_tick else None

"""Device microseconds a tick in every operation of a loop cell's traced
window other than K1 (``sqp_kernel``) and K2 (``tick_kernel``): the tick's
small kernels and its buffer copies."""

KERNELS = ("sqp_kernel", "tick_kernel")


def read(run, cell):
    if run.trace is None or not run.trace.ops or not run.trace.ticks:
        return None
    total, _ = run.trace.op_seconds()
    other = total - sum(run.trace.op_seconds(k)[0] for k in KERNELS)
    return other / run.trace.ticks * 1e6

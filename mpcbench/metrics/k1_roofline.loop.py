"""K1's share of its roofline in a loop cell, in percent: the least time
the card could take for one launch's work (``work/k1.py`` at the cell's B,
N, iterations and alphas, against ``work/peaks.py``) over K1's device time
a launch in the traced window (kernels named ``sqp_kernel``)."""
from mpcbench.work import k1, peaks

KERNEL = "sqp_kernel"


def read(run, cell):
    if run.trace is None:
        return None
    seconds, launches = run.trace.op_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    c = cell.config
    bound, _ = peaks.bound_s(*k1.work(c["batch_size"], c["horizon"], c["sqp"]["max_iters"],
                                      c["sqp"]["num_alphas"]))
    return 100.0 * bound / (seconds / launches)

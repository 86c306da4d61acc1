"""K1's share of its roofline in a point-to-goal cell, in percent: the
least time the card could take for one launch's work at a zero wrench
(``work/k1_zero_wrench.py`` at the cell's B, N, iterations and alphas,
against ``work/peaks.py``) over K1's device time a launch in the traced
window (kernels named ``sqp_kernel``).  ``k1_roofline.loop``'s count holds
a wrench on every lane, which ``run_mpc``'s solve does not pass."""
from mpcbench.work import k1_zero_wrench, peaks

KERNEL = "sqp_kernel"


def read(run, cell):
    if run.trace is None:
        return None
    seconds, launches = run.trace.op_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    c = cell.config
    bound, _ = peaks.bound_s(*k1_zero_wrench.work(c["batch_size"], c["horizon"],
                                                  c["sqp"]["max_iters"], c["sqp"]["num_alphas"]))
    return 100.0 * bound / (seconds / launches)

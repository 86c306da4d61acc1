"""K2's share of its roofline in a loop cell, in percent: the least time
the card could take for one launch's work (``work/k2.py``: B hypotheses and
the plant's substeps, friction and noise, against ``work/peaks.py``) over
K2's device time a launch in the traced window (kernels named
``tick_kernel``).  K2's latency floor, a chain of 4 (1 + substeps)
forward-dynamics calls, lies far above this bound."""
from mpcbench.work import k2, peaks

KERNEL = "tick_kernel"


def read(run, cell):
    if run.trace is None:
        return None
    seconds, launches = run.trace.op_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    c, p = cell.config, cell.config["plant"]
    bound, _ = peaks.bound_s(*k2.work(
        c["batch_size"], p["substeps"], bool(p["viscous_friction"] or p["coulomb_friction"]),
        bool(p["torque_noise_std"])))
    return 100.0 * bound / (seconds / launches)

"""K1's work at a zero wrench (no wrench passed: ``use_wrench`` 0), as
``run_mpc``'s single-lane solve launches it: ``work/k1.py``'s count less
what the wrench adds, counted the same way at one lane and frozen here.

With no wrench K1 skips the wrench map and its tangent: a running knot's
dynamics item loses the wrench map to the end effector, each of its
twelve tangent passes the map's tangent, each candidate's merit the map
again; 6 fewer floats are read.
"""
from . import k1

# Operations the wrench adds to one lane's items (k1's, with the wrench,
# less the same items counted without it).
DYNAMICS_WRENCH = 849      # 6287 - 5438
TANGENT_WRENCH = 1947      # 7260 - 5313
LINE_SEARCH_WRENCH = 849   # 6827 - 5978


def work(B: int, N: int, iters: int, alphas: int):
    """(flops, bytes) of one launch with no wrench."""
    flops, nbytes = k1.work(B, N, iters, alphas)
    n = N - 1
    flops -= B * iters * n * (DYNAMICS_WRENCH + 12 * TANGENT_WRENCH
                              + alphas * LINE_SEARCH_WRENCH)
    return flops, nbytes - 4 * B * 6

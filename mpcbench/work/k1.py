"""K1's work: one batched SQP solve (B lanes, horizon N, ``iters``
Gauss-Newton iterations, ``alphas`` line-search candidates), counted
from the problem's sizes alone.

Per lane and iteration: stage 1 linearizes the Euler dynamics at each
running knot (forward dynamics, dt M^-1, twelve one-tangent forward-mode
passes of the wrench map and RNEA, each with an LDL solve) and builds
every knot's Gauss-Newton cost data; stage 2 is the Riccati sweep, stage
3 the linear rollout, stage 4 the line search (each candidate's merit:
cost, Euler defects by forward dynamics) with the step norm and the
update.  The per-item counts are floating-point operations of the fig-8
cost (end-effector tracking with the joint-range barrier and the 1 / (|e|
+ eps) regularization, a wrench on every lane), counted once at one lane
and frozen here; a multiply-add is two.  Bytes read each input (xs,
goals, X, U, wrench, rho) and write each output (X, U, rho, alphas,
steps) once, in float32.
"""

# Operations of one lane's items.
DYNAMICS = 6287        # forward dynamics, dt M^-1 columns, defect norms
COST = 1121            # EE Jacobian, scaled GN cost data, barrier
TANGENT = 7260         # one tangent of d RNEA / dx and its LDL solve
LINE_SEARCH = 6827     # one running knot's candidate merit
LINE_SEARCH_END = 934  # the terminal knot's candidate cost
RICCATI_KNOT = 9990    # one running knot of the backward sweep
RICCATI_END = 414      # the terminal knot's S and s
ROLLOUT_KNOT = 390     # du = K dx + k, dx' = A dx + B du + d


def work(B: int, N: int, iters: int, alphas: int):
    """(flops, bytes) of one launch."""
    n = N - 1
    stage1 = n * DYNAMICS + N * COST + 12 * n * TANGENT + n * 6 + 7
    stage2 = n * RICCATI_KNOT - 66 * 2 + RICCATI_END
    stage3 = n * ROLLOUT_KNOT
    stage4 = (alphas * (n * LINE_SEARCH + LINE_SEARCH_END) + alphas * (2 * n + 3)
              + N * 24 + n * 12 + N + 2 + N * 24 + n * 12)
    flops = B * iters * (stage1 + stage2 + stage3 + stage4)
    floats = 12 + 3 * N + 2 * (12 * N + 6 * n) + 2 + 2 * iters + 6
    return flops, 4 * B * floats

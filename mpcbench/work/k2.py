"""K2's work: one tick epilogue (B hypotheses, ``substeps`` plant RK4
steps, 0 when the plant step is skipped), counted from the sizes alone.

Per forward-dynamics call: the six joint rotations, the bias RNEA, the
mass matrix by the composite-rigid-body algorithm and its LDL^T with a
solve.  Per RK4 step: four such calls, the wrench map to the end effector
and the stage combinations.  Per hypothesis: one RK4 step of the previous
state and torque, the joint stops and the squared error.  The plant: per
substep an RK4 step with the friction at each stage, the joint stops and
the actuation noise; then the trace forward kinematics.  Counts frozen
at one lane; a multiply-add is two.  Its latency floor is the chain of
4 * (1 + substeps) dependent forward-dynamics calls.  Bytes read each
input (both models' constants, the states, torques and hypotheses; with
the plant the true wrench and noise) and write each output once.
"""

ROTATIONS = 486
BIAS_RNEA = 1719
CRBA = 2042
LDL_SOLVE = 204
FRICTION = 36
WRENCH_MAP = 357
TRACE_FK = 801
RK4_COMBINATIONS = 156
CLAMP = 12
SQUARED_ERROR = 36
MODEL_FLOATS = 195


def work(B: int, substeps: int, friction: bool = True, noise: bool = True):
    """(flops, bytes) of one launch."""
    fd = ROTATIONS + BIAS_RNEA + CRBA + LDL_SOLVE
    rk4 = 4 * fd + WRENCH_MAP + RK4_COMBINATIONS
    flops = B * (rk4 + CLAMP + SQUARED_ERROR) + CLAMP + TRACE_FK
    if substeps:
        step = rk4 + CLAMP + (4 * FRICTION if friction else 0) + (6 if noise else 0)
        flops += substeps * step + CLAMP
    floats = 2 * MODEL_FLOATS + 12 + 6 + 12 + 12 * B + B + 2 + 6 + 3 + 6
    if substeps:
        floats += 6 + (6 * substeps if noise else 0) + 12
    return flops, 4 * floats

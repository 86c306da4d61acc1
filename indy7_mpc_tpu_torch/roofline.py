"""The least time an H100 could take for a kernel's work: its roofline bound.

``count_flops(fn, *args)``, or ``with FlopCounter() as c``, runs ``fn``
under a ``TorchDispatchMode`` and counts the floating-point operations of
every aten call: one per output element of an elementwise operation (two
for ``addcmul``/``addcdiv``), one per input element of a reduction, 2mnk
for a matrix product.  Copies, views, selections and comparisons count
nothing.

Both kernels' bounds count the work the kernel's function needs, item by
item, not what their plain versions' PyTorch calls do.

**K1.**  Its plain version does work the kernel does not (forward-mode AD with a
zero tangent on every model constant, the alpha = 0 line-search
candidate, dense Riccati products), so :func:`k1_work` counts the kernel's
own arithmetic instead: each item of ``csrc/sqp_kernel.cu`` that runs the
rigid-body engine (dynamics, cost, tangent and line-search items) is
replayed at one lane through ``ops/lane_rbd.py`` with the model constants
plain and the tangent pass on :class:`_Dual`, the kernel's one-tangent
number, and counted; the Riccati sweep, rollout, sums and update are
counted from the kernel's loops.  Work the kernel repeats across threads
for parallelism (the 13 Quu factorizations of a knot, du in each rollout
row, S's symmetrization at each read) counts once, as do the joint
rotations that the tangent pass forms again in its backward pass to keep
its link forces in registers (``rnea_tangent`` in ``csrc/rbd.cuh``).

**K2.**  :func:`k2_work` counts the work K2's function needs, item by
item at one lane: per forward-dynamics call the six joint rotations, the
bias RNEA, the mass matrix by the CRBA (the cheaper of the two ways to
get it), the LDL^T and its solves, and the plant's friction; per RK4 step
the wrench-map FK from those rotations and the RK4 combinations; per
lane the joint stops (their clamps) and the squared error; then the
plant's noise and the trace FK.  Each item is replayed through
``ops/lane_rbd.py`` or the kernel's expressions on tensors and counted;
the argmin is comparisons only.  The kernel itself builds M from six
unit-acceleration RNEA passes run beside the bias pass
(``csrc/rbd_team.cuh``), 6 * ``unit_rnea`` flops where the CRBA needs
``crba``: that redundancy buys lockstep, and is not counted as work.

``bound_ms`` is the larger of that work over the card's float32 rate and
the bytes the function must move (each input read once, each output
written once) over its memory rate: NVIDIA's H100 SXM data sheet, 67
TFLOP/s float32 outside the tensor cores and 3.35 TB/s, at the full 700 W
power limit.
"""
from __future__ import annotations

import functools
from typing import Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .config import CostConfig, SQPConfig
from .models import indy7
from .ops import lane_rbd as LR

H100_F32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12

_ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "sqrt", "rsqrt", "reciprocal",
    "sin", "cos", "tan", "tanh", "exp", "log", "pow", "abs", "maximum",
    "minimum", "clamp", "clamp_min", "clamp_max", "square", "sign", "atan2",
))
_DOUBLE = frozenset(("addcmul", "addcdiv"))
_REDUCTIONS = frozenset(("sum", "mean", "amax", "amin", "max", "min", "prod"))


def _numel(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel()
    if isinstance(out, (tuple, list)):
        return sum(_numel(o) for o in out)
    return 0


class FlopCounter(TorchDispatchMode):
    """``with FlopCounter() as c: ...`` counts into ``c.flops``."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in _ELEMENTWISE:
            self.flops += _numel(out)
        elif name in _DOUBLE:
            self.flops += 2 * _numel(out)
        elif name in _REDUCTIONS and isinstance(args[0], torch.Tensor):
            self.flops += args[0].numel()
        elif name in ("mm", "addmm", "bmm", "baddbmm"):
            a, b = (args[1], args[2]) if name.startswith(("addmm", "baddbmm")) else args[:2]
            self.flops += 2 * a.numel() * b.shape[-1]
        elif name in ("mv", "dot", "vdot"):
            self.flops += 2 * args[0].numel()
        return out


def count_flops(fn, *args, **kwargs) -> int:
    """Floating-point operations of ``fn(*args, **kwargs)`` (see module doc)."""
    counter = FlopCounter()
    with counter:
        fn(*args, **kwargs)
    return counter.flops


def tensor_bytes(tensors: Iterable) -> int:
    """Bytes of the tensors in ``tensors`` (None entries skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(flops: int, nbytes: int):
    """(bound in ms, "operations" or "bytes"): the larger of the two times."""
    t_ops = flops / H100_F32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# K1's work, from the kernel's own arithmetic.
# ---------------------------------------------------------------------------

class _Dual:
    """``Dual`` of csrc/rbd.cuh on tensors: value ``v``, one tangent ``d``.
    A product with a plain operand costs two multiplications, one of two
    Duals three and an add, a sum with a plain operand one add."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v, self.d = v, d

    def __add__(self, o):
        return _Dual(self.v + o.v, self.d + o.d) if isinstance(o, _Dual) else _Dual(self.v + o, self.d)

    __radd__ = __add__

    def __sub__(self, o):
        return _Dual(self.v - o.v, self.d - o.d) if isinstance(o, _Dual) else _Dual(self.v - o, self.d)

    def __rsub__(self, o):
        return _Dual(o - self.v, -self.d)

    def __neg__(self):
        return _Dual(-self.v, -self.d)

    def __mul__(self, o):
        if isinstance(o, _Dual):
            return _Dual(self.v * o.v, self.d * o.v + self.v * o.d)
        return _Dual(self.v * o, self.d * o)

    __rmul__ = __mul__

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        x = args[0]
        if func is torch.sin:
            return _Dual(torch.sin(x.v), torch.cos(x.v) * x.d)
        if func is torch.cos:
            return _Dual(torch.cos(x.v), -torch.sin(x.v) * x.d)
        return NotImplemented  # Tensor * _Dual falls back to __rmul__


def _sumsq(xs):
    return torch.stack(list(xs)).square().sum()


# The items below replay csrc/sqp_kernel.cu's device functions at one lane
# under the counter; they drop what they compute, since only their
# operations count.


def _barrier(sm, cfg, q):
    """barrier() of sqp_kernel.cu: value, gradient and Hessian diagonal."""
    w, cb, gb, hb = cfg.q_barrier, 0.0, [], []
    for i in range(6):
        d_hi = torch.clamp(q[i] - (sm.c["q_upper"][i] - cfg.q_barrier_margin), min=0.0)
        d_lo = torch.clamp((sm.c["q_lower"][i] + cfg.q_barrier_margin) - q[i], min=0.0)
        cb = cb + w * (d_hi * d_hi + d_lo * d_lo)
        gb.append(2.0 * w * (d_hi - d_lo))
        hb.append(2.0 * w * ((d_hi > 0.0) | (d_lo > 0.0)).float())
    return cb, gb, hb


def _dynamics_item(sm, dt, x, xn, u, w):
    """dynamics_item: forward dynamics, dt M^-1, Euler defect, norms."""
    q, v = LR.split(x)
    a, fac = LR.forward_dynamics(sm, q, v, [u[i] for i in range(6)],
                                 LR.f_ext_from_world(sm, q, w))
    for j in range(6):
        [dt * c for c in LR.chol6_solve(fac, [float(i == j) for i in range(6)])]
    dq = [(q[i] + dt * v[i]) - xn[i] for i in range(6)]
    dv = [(v[i] + dt * a[i]) - xn[6 + i] for i in range(6)]
    torch.sqrt(_sumsq(dq)) + torch.sqrt(_sumsq(dv))
    _sumsq(u)
    return a, fac


def _cost_item(sm, cfg, x, goal):
    """cost_item: EE Jacobian, scaled GN cost data, barrier, terms."""
    q = [x[i] for i in range(6)]
    p, cols = LR.ee_pos_jacobian(sm, q)
    err = LR.sub3(p, goal)
    err2 = LR.dot3(err, err)
    scale = 1.0 / (torch.sqrt(err2) + cfg.eps) if cfg.regularize else 1.0
    twodQ, _ = 2.0 * cfg.dQ * scale, 2.0 * cfg.R * scale
    _, gb, _ = _barrier(sm, cfg, q) if cfg.q_barrier else (0.0, [0.0] * 6, None)
    for i in range(6):
        2.0 * LR.dot3(cols[i], err) + gb[i]
        twodQ * x[6 + i]
    _sumsq(x[6:])


def _tangent_item(sm, dt, x, a, fac, w, t):
    """tangent_item: one one-tangent Dual pass of the wrench map and RNEA,
    an LDL solve and a column of dt da."""
    xd = [_Dual(x[i], torch.full_like(x[i], float(i == t))) for i in range(12)]
    ad = [_Dual(a[i], torch.zeros_like(a[i])) for i in range(6)]
    fe = LR.f_ext_from_world(sm, xd[:6], w)
    tau = LR.rnea(sm, xd[:6], xd[6:], ad, f_ext_ee=fe)
    [dt * -s for s in LR.chol6_solve(fac, [tau_i.d for tau_i in tau])]


def _merit_knot_cost(sm, cfg, x, goal, qmod):
    pe = LR.ee_pos(sm, [x[i] for i in range(6)])
    pos = _sumsq(LR.sub3(pe, goal))
    if cfg.q_barrier:
        pos = pos + _barrier(sm, cfg, x[:6])[0]
    return qmod * pos + cfg.dQ * _sumsq(x[6:])


def _line_search_item(sm, cfg, dt, x, dx, xn, dxn, u, du, goal, w, terminal):
    """line_search_item at one alpha: the candidate's merit cost and, for a
    running knot, its Euler defect norms."""
    alpha = 0.5
    xc = x + alpha * dx
    if terminal:
        _merit_knot_cost(sm, cfg, xc, goal, cfg.QN)
        return
    xnc, uc = xn + alpha * dxn, u + alpha * du
    _merit_knot_cost(sm, cfg, xc, goal, 1.0) + cfg.R * _sumsq(uc)
    q, v = LR.split(xc)
    acc, _ = LR.forward_dynamics(sm, q, v, [uc[i] for i in range(6)],
                                 LR.f_ext_from_world(sm, q, w))
    eq = [(xc[i] + dt * xc[6 + i]) - xnc[i] for i in range(6)]
    ev = [(xc[6 + i] + dt * acc[i]) - xnc[6 + i] for i in range(6)]
    torch.sqrt(_sumsq(eq)) + torch.sqrt(_sumsq(ev))


@functools.lru_cache(maxsize=None)
def _k1_item_flops(cost_cfg: CostConfig, use_wrench: bool):
    """Flops of K1's rigid-body items at one lane: (dynamics, cost, tangent,
    running line-search, terminal line-search)."""
    sm = LR.static_model(indy7(torch.float32))
    gen = torch.Generator().manual_seed(0)
    r = lambda n, s=0.1: s * torch.randn((n, 1), generator=gen)
    x, xn, dx, dxn, u, du, g = r(12), r(12), r(12), r(12), r(6, 1.0), r(6, 1.0), r(3)
    w = r(6, 8.0) if use_wrench else None
    dt = 0.01
    counts = []
    with FlopCounter() as c:
        a, fac = _dynamics_item(sm, dt, x, xn, u, w)
    counts.append(c.flops)
    counts.append(count_flops(_cost_item, sm, cost_cfg, x, g))
    counts.append(count_flops(_tangent_item, sm, dt, x, a, fac, w, 0))
    for terminal in (False, True):
        counts.append(count_flops(_line_search_item, sm, cost_cfg, dt, x, dx, xn, dxn,
                                  u, du, g, w, terminal))
    return tuple(counts)


# The Riccati sweep of one running knot (backward_sweep), the kernel's
# products with A = I + [0 dt I; dt da] and B = [0; dt M^-1] in their
# structure; a multiply-add is 2.
_RICCATI_KNOT = (
    66 * 2                       # S = (S' + S'^T) / 2 (off-diagonal pairs)
    + 144 * 12 + 72 * 2          # SA = S A
    + 72 * 12                    # SB = S B
    + 12 * (24 + 1)              # Sc = S d + s
    + 144 * (12 + 1) + 72 * 2    # Qxx = A^T SA + Q
    + 36 * 11 + 6 * 2            # Q's entries from J and sc
    + 72 * 12 + 36 * 2           # Qxu = A^T SB
    + 21 * 12 + 6 * 2            # Quu = B^T SB + (2R + rho) I, lower triangle
    + 12 * 12 + 6 * 2            # qx = A^T Sc
    + 6 * (12 + 2)               # qu = B^T Sc + 2R u
    + 126                        # LDL^T of Quu
    + 13 * (66 + 6)              # K and kff: 13 solves, negated
    + 144 * 12                   # S' = Qxx + Qxu K
    + 12 * (2 + 12)              # s = qx + q + Qxu kff
)
_RICCATI_TERMINAL = 36 * 11 + 6 * 2 + 6    # S, s of the terminal knot
_ROLLOUT_KNOT = 6 * (24 + 1) + 6 * 2 + 6 * 36 + 12  # du = K dx + kff; dx'


def k1_work(B: int, N: int, cost_cfg: CostConfig = CostConfig(),
            sqp_cfg: SQPConfig = SQPConfig(), use_wrench: bool = True):
    """(flops, bytes) of one K1 launch: B lanes, horizon N, ``max_iters``
    SQP iterations (the kernel always runs them all), from the kernel's
    own arithmetic (see module doc); the bytes read its inputs (xs,
    goals, X, U, wrench, rho) and write its outputs (X, U, rho, alphas,
    steps) once."""
    dyn, cost, tangent, ls_run, ls_term = _k1_item_flops(cost_cfg, use_wrench)
    Nm1, NA = N - 1, sqp_cfg.num_alphas
    stage1 = Nm1 * dyn + N * cost + 12 * Nm1 * tangent + Nm1 * 6 + 7  # + base merit
    stage2 = Nm1 * _RICCATI_KNOT - 66 * 2 + _RICCATI_TERMINAL  # terminal S read raw
    stage3 = Nm1 * _ROLLOUT_KNOT
    stage4 = (NA * (Nm1 * ls_run + ls_term)
              + NA * (2 * Nm1 + 3)                    # per-alpha merits
              + N * 24 + Nm1 * 12 + N + 2             # step norm
              + N * 24 + Nm1 * 12)                    # masked update
    flops = B * sqp_cfg.max_iters * (stage1 + stage2 + stage3 + stage4)
    floats = (12 + 3 * N + 2 * (12 * N + 6 * Nm1) + 2 + 2 * sqp_cfg.max_iters
              + (6 if use_wrench else 0))
    return flops, 4 * B * floats


# ---------------------------------------------------------------------------
# K2's work, item by item.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _k2_item_flops():
    """Flops of K2's items at one lane (see module doc), by name."""
    sm = LR.static_model(indy7(torch.float32))
    gen = torch.Generator().manual_seed(0)
    r = lambda s=0.1: [s * torch.randn(1, generator=gen) for _ in range(6)]
    q, v, u, w = r(), r(), r(5.0), r(8.0)
    zero = [torch.zeros(1) for _ in range(6)]
    rot = count_flops(LR._local_placements, sm, q)
    fac = LR.chol6(LR.crba(sm, q))  # a factor to count the solves on
    items = {
        "rotations": rot,
        "bias_rnea": count_flops(LR.rnea, sm, q, v, zero,
                                 f_ext_ee=(w[:3], w[3:])) - rot,
        "crba": count_flops(LR.crba, sm, q) - rot,
        "unit_rnea": count_flops(LR.rnea, sm, q, zero, [torch.ones(1)] + zero[1:],
                                 f_ext_ee=(zero[:3], zero[3:])) - rot,
        "ldl_solve": count_flops(LR.chol6, [[v[i] * v[j] for j in range(6)] for i in range(6)])
        + count_flops(lambda: LR.chol6_solve(fac, [u[i] - v[i] for i in range(6)])),
        "friction": count_flops(lambda: [u[i] - 0.05 * v[i] - 0.1 * torch.tanh(v[i] / 0.01)
                                         for i in range(6)]),
        "wrench_map": count_flops(LR.world_wrench_to_ee, sm, q, w) - rot,
        "trace_fk": count_flops(LR.ee_pos, sm, q),
    }

    def rk4_combinations(h=0.002):
        half = h / 2.0
        for i in range(6):  # the stage inputs of stages 2-4, then the update
            q[i] + half * v[i], v[i] + half * u[i]
            q[i] + half * v[i], v[i] + half * u[i]
            q[i] + h * v[i], v[i] + h * u[i]
            q[i] + h / 6.0 * (v[i] + 2.0 * u[i] + 2.0 * w[i] + v[i])
            v[i] + h / 6.0 * (u[i] + 2.0 * w[i] + 2.0 * v[i] + u[i])

    items["rk4_combinations"] = count_flops(rk4_combinations)
    lo, hi = torch.full((1,), -1.0), torch.full((1,), 1.0)
    items["clamp"] = count_flops(  # fminf(fmaxf(x, lo), hi) per joint
        lambda: [torch.minimum(torch.maximum(q[i], lo), hi) for i in range(6)])
    x, y = q + v, u + w
    items["squared_error"] = count_flops(
        lambda: sum(d * d for d in (x[i] - y[i] for i in range(12))))
    return items


def k2_work(B: int, substeps: int, friction: bool, use_noise: bool,
            saturate: bool = False):
    """(flops, bytes) of one K2 launch: B lanes, ``substeps`` plant RK4
    steps (0: the plant skipped), from the work its function needs (see
    module doc).  The bytes read each input once (the two models'
    constants, the states, controls and hypotheses; the true wrench and
    noise with the plant) and write each output once.  K2's latency floor is its chain of
    dependent forward-dynamics calls, 4 * (1 + substeps)."""
    it = _k2_item_flops()
    fd = it["rotations"] + it["bias_rnea"] + it["crba"] + it["ldl_solve"]
    rk4 = 4 * fd + it["wrench_map"] + it["rk4_combinations"]
    lane = rk4 + it["clamp"] + it["squared_error"]   # + q clamped to its range
    flops = B * lane + it["clamp"] + it["trace_fk"]  # + u_last clamped
    if substeps:
        step = rk4 + it["clamp"] * (2 if saturate else 1)
        step += 4 * it["friction"] if friction else 0
        step += 6 if use_noise else 0
        flops += substeps * step + it["clamp"]       # + the winner's u clamped
    floats = (2 * 195 + 12 + 6 + 12 + 12 * B                    # models, x_last, u_last, x_cur
              + ((6 + (6 * substeps if use_noise else 0) + 12) if substeps else 0)  # f_true, noise, x_next
              + B + 2 + 6 + 3 + 6)                              # err, best, u, eep, f_est
    return flops, 4 * floats

"""Lane-major structure-of-arrays rigid-body engine (port of ops/lane_rbd.py).

Every quantity is decomposed into scalar components over a flat lane axis
``L``: 3-vectors are tuples of (L,) tensors, 3x3 matrices nested tuples,
joint vectors lists of length ``nj``.  Scalars may be Python floats or 0-d
tensors (the model constants).  The functions are dtype-generic and run on
any device; they are the plain PyTorch versions of the device functions in
``csrc/rbd.cuh``.

Unlike the TPU package, sin/cos/sqrt are the exact library functions: the
polynomial ``sincos`` and bit-trick ``fast_sqrt`` worked around the TPU
vector unit's slow transcendentals and are not carried over.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.robot import RobotModel

# ---------------------------------------------------------------------------
# Model constants.
# ---------------------------------------------------------------------------

STATIC_FIELDS = (
    "tree_R", "tree_p", "axis", "mass", "h", "I_o", "gravity",
    "q_lower", "q_upper", "effort_limit", "velocity_limit",
)


@dataclasses.dataclass(frozen=True, eq=False)
class StaticModel:
    """Dynamics constants of a RobotModel, as tensors on one device.

    The fields of the TPU package's ``StaticModel`` plus the actuator
    effort and URDF velocity limits, which the tick epilogue needs.
    """

    tree_R: torch.Tensor   # (nj, 3, 3)
    tree_p: torch.Tensor   # (nj, 3)
    axis: torch.Tensor     # (nj, 3)
    mass: torch.Tensor     # (nj,)
    h: torch.Tensor        # (nj, 3) first moments m*c
    I_o: torch.Tensor      # (nj, 3, 3) inertia about the joint origin
    gravity: torch.Tensor  # (3,)
    q_lower: torch.Tensor  # (nj,)
    q_upper: torch.Tensor  # (nj,)
    effort_limit: torch.Tensor    # (nj,)
    velocity_limit: torch.Tensor  # (nj,)

    @property
    def nj(self) -> int:
        return self.mass.shape[0]

    @functools.cached_property
    def c(self):
        """The fields as nested tuples of 0-d tensors (indexed once)."""

        def nest(t):
            if t.dim() == 0:
                return t
            return tuple(nest(s) for s in t.unbind(0))

        return {f: nest(getattr(self, f)) for f in STATIC_FIELDS}

    @functools.cached_property
    def host(self):
        """The fields as flat lists of Python floats (for kernel constants).

        Read once per StaticModel; this synchronises with the device.
        """
        return {
            f: getattr(self, f).detach().double().cpu().reshape(-1).tolist()
            for f in STATIC_FIELDS
        }


def static_model(model: RobotModel) -> StaticModel:
    """The StaticModel of ``model``, computed on the host in float64 with
    the TPU package's numpy arithmetic, then cast to the model's dtype and
    device."""
    dtype, device = model.mass.dtype, model.mass.device
    f = {k: getattr(model, k).detach().cpu().double().numpy() for k in (
        "tree_R", "tree_p", "axis", "mass", "com", "I_com", "gravity",
        "q_lower", "q_upper", "effort_limit", "velocity_limit",
    )}
    mass, com = f["mass"], f["com"]
    I_o = np.zeros_like(f["I_com"])
    for i in range(mass.shape[0]):
        c = com[i]
        I_o[i] = f["I_com"][i] + mass[i] * (c @ c * np.eye(3) - np.outer(c, c))
    arrays = dict(f, h=mass[:, None] * com, I_o=I_o)
    return StaticModel(
        **{
            k: torch.as_tensor(arrays[k], dtype=dtype, device=device)
            for k in STATIC_FIELDS
        }
    )


# ---------------------------------------------------------------------------
# Tuple-of-(L,) algebra.
# ---------------------------------------------------------------------------

def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def smul3(s, a):
    return (s * a[0], s * a[1], s * a[2])


def cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def mv33(M, a):
    """M (3x3 nested tuple) @ a."""
    return tuple(
        M[i][0] * a[0] + M[i][1] * a[1] + M[i][2] * a[2] for i in range(3)
    )


def mtv33(M, a):
    """M^T @ a."""
    return tuple(
        M[0][i] * a[0] + M[1][i] * a[1] + M[2][i] * a[2] for i in range(3)
    )


def mm33(A, B):
    return tuple(
        tuple(
            A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j]
            for j in range(3)
        )
        for i in range(3)
    )


def rot_axis_t(axis, c, s):
    """Rodrigues rotation about a constant ``axis`` with cos/sin (L,)."""
    ax, ay, az = axis
    one_c = 1.0 - c
    return (
        (c + ax * ax * one_c, ax * ay * one_c - az * s, ax * az * one_c + ay * s),
        (ay * ax * one_c + az * s, c + ay * ay * one_c, ay * az * one_c - ax * s),
        (az * ax * one_c - ay * s, az * ay * one_c + ax * s, c + az * az * one_c),
    )


# ---------------------------------------------------------------------------
# Kinematics.
# ---------------------------------------------------------------------------

def _local_placements(sm: StaticModel, q: Sequence):
    c = sm.c
    out = []
    for i in range(sm.nj):
        R_joint = rot_axis_t(c["axis"][i], torch.cos(q[i]), torch.sin(q[i]))
        out.append((mm33(c["tree_R"][i], R_joint), c["tree_p"][i]))
    return out


def fk(sm: StaticModel, q: Sequence):
    """World placements of every joint frame: lists of (R, p) per joint.

    ``q`` is a length-nj sequence of (L,) tensors.
    """
    Rs, ps = [], []
    R_w, p_w = None, None
    for i, (R_li, p_li) in enumerate(_local_placements(sm, q)):
        if i == 0:
            R_w, p_w = R_li, p_li
        else:
            p_w = add3(p_w, mv33(R_w, p_li))
            R_w = mm33(R_w, R_li)
        Rs.append(R_w)
        ps.append(p_w)
    return Rs, ps


def ee_pos(sm: StaticModel, q: Sequence):
    return fk(sm, q)[1][-1]


def ee_pos_jacobian(sm: StaticModel, q: Sequence):
    """EE position and the 3 x nj position Jacobian (columns as tuples)."""
    Rs, ps = fk(sm, q)
    p_ee = ps[-1]
    cols = []
    for i in range(sm.nj):
        axis_w = mv33(Rs[i], sm.c["axis"][i])
        cols.append(cross3(axis_w, sub3(p_ee, ps[i])))
    return p_ee, cols


def world_wrench_to_ee(sm: StaticModel, q: Sequence, w: Sequence):
    """World wrench (f, n about the world origin) -> EE joint-local (f, n)."""
    Rs, ps = fk(sm, q)
    R, p = Rs[-1], ps[-1]
    f = (w[0], w[1], w[2])
    n = (w[3], w[4], w[5])
    return mtv33(R, f), mtv33(R, sub3(n, cross3(p, f)))


# ---------------------------------------------------------------------------
# RNEA, CRBA, LDL^T, forward dynamics.
# ---------------------------------------------------------------------------

def rnea(sm: StaticModel, q, v, a, f_ext_ee=None, gravity: bool = True):
    """Inverse dynamics; joint vectors are length-nj lists of (L,).

    ``f_ext_ee``: optional (f tuple, n tuple) local spatial force on the
    last link.  Returns a list of nj torques.
    """
    nj = sm.nj
    c = sm.c
    g = c["gravity"] if gravity else (0.0, 0.0, 0.0)
    placements = _local_placements(sm, q)
    f_lin = [None] * nj
    f_ang = [None] * nj
    vp_lin = vp_ang = ap_ang = (0.0, 0.0, 0.0)
    ap_lin = (-g[0], -g[1], -g[2])

    for i in range(nj):
        R, p = placements[i]
        axis = c["axis"][i]
        wi = mtv33(R, vp_ang)
        vi = mtv33(R, add3(vp_lin, cross3(vp_ang, p)))
        vJ = smul3(v[i], axis)
        wi = add3(wi, vJ)

        ai_ang = mtv33(R, ap_ang)
        ai_lin = mtv33(R, add3(ap_lin, cross3(ap_ang, p)))
        ai_ang = add3(ai_ang, add3(smul3(a[i], axis), cross3(wi, vJ)))
        ai_lin = add3(ai_lin, cross3(vi, vJ))

        m, h, I_o = c["mass"][i], c["h"][i], c["I_o"][i]
        Iv_lin = sub3(smul3(m, vi), cross3(h, wi))
        Iv_ang = add3(mv33(I_o, wi), cross3(h, vi))
        Ia_lin = sub3(smul3(m, ai_lin), cross3(h, ai_ang))
        Ia_ang = add3(mv33(I_o, ai_ang), cross3(h, ai_lin))
        fi_lin = add3(Ia_lin, cross3(wi, Iv_lin))
        fi_ang = add3(Ia_ang, add3(cross3(wi, Iv_ang), cross3(vi, Iv_lin)))

        if f_ext_ee is not None and i == nj - 1:
            fe, ne = f_ext_ee
            fi_lin = sub3(fi_lin, fe)
            fi_ang = sub3(fi_ang, ne)

        f_lin[i], f_ang[i] = fi_lin, fi_ang
        vp_lin, vp_ang = vi, wi
        ap_lin, ap_ang = ai_lin, ai_ang

    tau = [None] * nj
    for i in range(nj - 1, -1, -1):
        tau[i] = dot3(f_ang[i], c["axis"][i])
        if i > 0:
            R, p = placements[i]
            fp = mv33(R, f_lin[i])
            np_ = add3(mv33(R, f_ang[i]), cross3(p, fp))
            f_lin[i - 1] = add3(f_lin[i - 1], fp)
            f_ang[i - 1] = add3(f_ang[i - 1], np_)
    return tau


def _shift_term(m, c, sign):
    cc = dot3(c, c)
    return tuple(
        tuple(
            sign * m * ((cc if i == j else 0.0) - c[i] * c[j]) for j in range(3)
        )
        for i in range(3)
    )


def _add33(A, B):
    return tuple(tuple(A[i][j] + B[i][j] for j in range(3)) for i in range(3))


def crba(sm: StaticModel, q):
    """Mass matrix as a 6x6 nested list of (L,) tensors (symmetric)."""
    nj = sm.nj
    c = sm.c
    placements = _local_placements(sm, q)
    comp_m = list(c["mass"])
    comp_h = list(c["h"])
    comp_I = list(c["I_o"])

    for i in range(nj - 1, 0, -1):
        R, p = placements[i]
        m, h, I_o = comp_m[i], comp_h[i], comp_I[i]
        ci = smul3(1.0 / m, h)
        c_new = add3(mv33(R, ci), p)
        I_c = _add33(I_o, _shift_term(m, ci, -1.0))
        Rt = tuple(tuple(R[j][i2] for j in range(3)) for i2 in range(3))
        I_c_new = mm33(mm33(R, I_c), Rt)
        I_o_new = _add33(I_c_new, _shift_term(m, c_new, 1.0))
        comp_m[i - 1] = comp_m[i - 1] + m
        comp_h[i - 1] = add3(comp_h[i - 1], smul3(m, c_new))
        comp_I[i - 1] = _add33(comp_I[i - 1], I_o_new)

    M = [[None] * nj for _ in range(nj)]
    for i in range(nj):
        axis = c["axis"][i]
        F_lin = smul3(-1.0, cross3(comp_h[i], axis))
        F_ang = mv33(comp_I[i], axis)
        M[i][i] = dot3(F_ang, axis)
        j = i
        while j > 0:
            R, p = placements[j]
            F_lin_p = mv33(R, F_lin)
            F_ang = add3(mv33(R, F_ang), cross3(p, F_lin_p))
            F_lin = F_lin_p
            j -= 1
            M[i][j] = dot3(F_ang, c["axis"][j])
            M[j][i] = M[i][j]
    return M


def chol6(M):
    """Unrolled LDL^T of a 6x6 SPD nested list: (L unit-lower, D, invD)."""
    n = 6
    Lc = [[None] * n for _ in range(n)]
    D = [None] * n
    invD = [None] * n
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = s - Lc[j][k] * Lc[j][k] * D[k]
        D[j] = s
        invD[j] = 1.0 / s
        for i in range(j + 1, n):
            t = M[i][j]
            for k in range(j):
                t = t - Lc[i][k] * Lc[j][k] * D[k]
            Lc[i][j] = t * invD[j]
    return Lc, D, invD


def chol6_solve(fac, b):
    """Solve (L D L^T) x = b; ``b`` is a length-6 list (entries broadcast)."""
    Lc, _, invD = fac
    n = 6
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - Lc[i][k] * y[k]
        y[i] = s
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i] * invD[i]
        for k in range(i + 1, n):
            s = s - Lc[k][i] * x[k]
        x[i] = s
    return x


def forward_dynamics(sm: StaticModel, q, v, tau, f_ext_ee=None, gravity=True):
    """a = M(q)^-1 (tau - bias); returns (a list, LDL factor for reuse)."""
    bias = rnea(sm, q, v, [0.0] * sm.nj, f_ext_ee=f_ext_ee, gravity=gravity)
    fac = chol6(crba(sm, q))
    a = chol6_solve(fac, [tau[i] - bias[i] for i in range(sm.nj)])
    return a, fac


# ---------------------------------------------------------------------------
# Integrators on (12, L) / (6, L) tensors.
# ---------------------------------------------------------------------------

def split(x):
    """(12, L) tensor -> (q list, v list)."""
    return [x[i] for i in range(6)], [x[6 + i] for i in range(6)]


def f_ext_from_world(sm: StaticModel, q, w: Optional[torch.Tensor]):
    if w is None:
        return None
    return world_wrench_to_ee(sm, q, [w[i] for i in range(6)])


def euler_step(sm: StaticModel, x, u, dt: float, wrench_world=None):
    """Explicit Euler on (12, L) states and (6, L) controls."""
    q, v = split(x)
    f_ext = f_ext_from_world(sm, q, wrench_world)
    a, _ = forward_dynamics(sm, q, v, [u[i] for i in range(6)], f_ext)
    return torch.stack(
        [q[i] + dt * v[i] for i in range(6)] + [v[i] + dt * a[i] for i in range(6)]
    )


def rk4_step(sm: StaticModel, x, u, dt: float, wrench_world=None, friction=None):
    """RK4 with the reference's averaged-velocity position update.

    The wrench is mapped once at the start state.  ``friction=(kv, kc)``
    adds -kv v - kc tanh(v / 0.01) to the torque in every stage.
    """
    q, v = split(x)
    uu = [u[i] for i in range(6)]
    f_ext = f_ext_from_world(sm, q, wrench_world)

    def fd(qq, vv):
        tau = uu
        if friction is not None:
            kv, kc = friction
            tau = [
                uu[i] - kv * vv[i] - kc * torch.tanh(vv[i] / 0.01)
                for i in range(6)
            ]
        return forward_dynamics(sm, qq, vv, tau, f_ext)[0]

    half = dt / 2.0
    k1q = v
    k1v = fd(q, v)
    q2 = [q[i] + half * k1q[i] for i in range(6)]
    k2q = [v[i] + half * k1v[i] for i in range(6)]
    k2v = fd(q2, k2q)
    q3 = [q[i] + half * k2q[i] for i in range(6)]
    k3q = [v[i] + half * k2v[i] for i in range(6)]
    k3v = fd(q3, k3q)
    q4 = [q[i] + dt * k3q[i] for i in range(6)]
    k4q = [v[i] + dt * k3v[i] for i in range(6)]
    k4v = fd(q4, k4q)
    return torch.stack(
        [
            q[i] + dt / 6.0 * (k1q[i] + 2 * k2q[i] + 2 * k3q[i] + k4q[i])
            for i in range(6)
        ]
        + [
            v[i] + dt / 6.0 * (k1v[i] + 2 * k2v[i] + 2 * k3v[i] + k4v[i])
            for i in range(6)
        ]
    )

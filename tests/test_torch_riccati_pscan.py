"""The port's parallel-scan Riccati (``ops/riccati_pscan.py``) against the
TPU package's, and against the port's sequential sweep, on the CPU in
float64.

  * ``backward_pscan``'s cost-to-go (S, s) and ``solve_pscan``'s X, U, K
    and kff against JAX, for one lane and for lanes batched against
    ``jax.vmap``, at N = 2, 7, 8 and 13 (lengths that are not powers of
    two included), and against ``ops/riccati.py::solve``;
  * the SQP solve with ``qp_backend="riccati_pscan"`` against the JAX
    solver, N=8, B=2, 2 SQP iterations.

Tolerance 1e-9 after scaling each lane by max(1, max |value|): one lane's
gradients and initial state are scaled by 1e3, so a reduction that ran
across lanes would show.  Each JAX program is jitted once per module.

``random_lanes`` is shared with tests/test_torch_pcg.py and
tests/test_torch_admm.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jcfg
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.ops import kkt as jkkt
from indy7_mpc_tpu.ops import riccati_pscan as jpscan
from indy7_mpc_tpu.solvers import sqp as jsqp
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.ops import riccati, riccati_pscan
from indy7_mpc_tpu_torch.ops.kkt import QPBlocks
from indy7_mpc_tpu_torch.solvers import sqp

TOL = 1e-9
LANE_SCALE = np.array([1.0, 1e3, 1.0])
RHO = np.array([1e-6, 1e-2, 1e-4])
NX, NU = 12, 6


def random_lanes(seed, N, scale=LANE_SCALE):
    """Well-posed QP blocks for len(scale) lanes, like
    tools/profile_pscan.py's; lane i's gradients (c, q, r) and initial
    state are scaled by scale[i], which scales its solution by the same.
    Returns (blocks as numpy arrays with a leading lane axis, xs)."""
    rng = np.random.default_rng(seed)
    B = len(scale)
    s = np.asarray(scale)[:, None, None]
    A = rng.normal(size=(B, N - 1, NX, NX)) * 0.1 + np.eye(NX)
    Bm = rng.normal(size=(B, N - 1, NX, NU)) * 0.1
    c = rng.normal(size=(B, N - 1, NX)) * 0.01 * s
    Qh = rng.normal(size=(B, N, NX, NX)) * 0.1
    Q = Qh @ Qh.swapaxes(-1, -2) + 0.1 * np.eye(NX)
    q = rng.normal(size=(B, N, NX)) * 0.1 * s
    Rh = rng.normal(size=(B, N - 1, NU, NU)) * 0.1
    R = Rh @ Rh.swapaxes(-1, -2) + 0.5 * np.eye(NU)
    r = rng.normal(size=(B, N - 1, NU)) * 0.1 * s
    xs = rng.normal(size=(B, NX)) * s[:, 0]
    return (A, Bm, c, Q, q, R, r), xs


def port_blocks(blocks, lane=None):
    sel = (lambda a: a) if lane is None else (lambda a: a[lane])
    return QPBlocks(*(torch.as_tensor(sel(a)) for a in blocks))


def jax_blocks(blocks, lane=None):
    sel = (lambda a: a) if lane is None else (lambda a: a[lane])
    return jkkt.QPBlocks(*(jnp.asarray(sel(a)) for a in blocks))


def assert_lanes_close(got, want, name, lanes=True, tol=TOL):
    """|got - want| <= tol * max(1, max |want|) per lane (the leading axis
    when ``lanes``, else the whole array as one lane)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if not lanes:
        got, want = got[None], want[None]
    axes = tuple(range(1, want.ndim))
    scale = np.maximum(1.0, np.abs(want).max(axis=axes, keepdims=True)) if axes else 1.0
    err = (np.abs(got - want) / scale).max()
    assert err <= tol, f"{name}: scaled error {err:.3e} > {tol:.0e}"


@pytest.fixture(scope="module")
def jax_pscan():
    """(N, batched) -> the JAX (backward_pscan, solve_pscan), jitted once."""
    one = lambda b, xs, rho: (jpscan.backward_pscan(b, rho), jpscan.solve_pscan(b, xs, rho))
    fns = {False: jax.jit(one), True: jax.jit(jax.vmap(one))}
    return lambda batched: fns[batched]


@pytest.mark.parametrize("N", [2, 7, 8, 13])
def test_pscan_matches_jax_one_lane(jax_pscan, N):
    blocks, xs = random_lanes(N, N)
    (jS, js), jsol = jax_pscan(False)(jax_blocks(blocks, 1), jnp.asarray(xs[1]), RHO[1])
    S, s = riccati_pscan.backward_pscan(port_blocks(blocks, 1), float(RHO[1]))
    sol = riccati_pscan.solve_pscan(port_blocks(blocks, 1), torch.as_tensor(xs[1]),
                                    float(RHO[1]))
    for name, got, want in (("S", S, jS), ("s", s, js), ("X", sol.X, jsol.X),
                            ("U", sol.U, jsol.U), ("K", sol.K, jsol.K),
                            ("kff", sol.kff, jsol.kff)):
        assert_lanes_close(got.numpy(), want, name, lanes=False)


@pytest.mark.parametrize("N", [2, 7, 8, 13])
def test_pscan_matches_jax_and_riccati_batched(jax_pscan, N):
    """Lanes of different scale and rho, batched against ``jax.vmap``; the
    same QP as the sequential sweep."""
    blocks, xs = random_lanes(100 + N, N)
    (jS, js), jsol = jax_pscan(True)(jax_blocks(blocks), jnp.asarray(xs), jnp.asarray(RHO))
    pb, pxs, prho = port_blocks(blocks), torch.as_tensor(xs), torch.as_tensor(RHO)
    S, s = riccati_pscan.backward_pscan(pb, prho)
    sol = riccati_pscan.solve_pscan(pb, pxs, prho)
    seq = riccati.solve(pb, pxs, prho)
    for name, got, want in (("S", S, jS), ("s", s, js), ("X", sol.X, jsol.X),
                            ("U", sol.U, jsol.U), ("K", sol.K, jsol.K),
                            ("kff", sol.kff, jsol.kff)):
        assert_lanes_close(got.numpy(), want, name)
    for name in ("X", "U", "K", "kff"):
        assert_lanes_close(getattr(sol, name).numpy(), getattr(seq, name).numpy(),
                           f"{name} vs riccati")


def test_pscan_float32_sweeps_in_float64():
    """The Riccati dtype policy: float32 blocks give the float64 solve,
    rounded."""
    blocks, xs = random_lanes(3, 8)
    pb, pxs = port_blocks(blocks), torch.as_tensor(xs)
    f32 = riccati_pscan.solve_pscan(QPBlocks(*(b.float() for b in pb)), pxs.float(),
                                    torch.as_tensor(RHO, dtype=torch.float32))
    f64 = riccati_pscan.solve_pscan(QPBlocks(*(b.float().double() for b in pb)),
                                    pxs.float().double(),
                                    torch.as_tensor(RHO, dtype=torch.float32).double())
    for got, want in zip(f32, f64):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.float().numpy())


# ---------------------------------------------------------------------------
# The SQP solve on the parallel-scan backend.
# ---------------------------------------------------------------------------

SQP_B, SQP_N, DT = 2, 8, 0.01
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]


def sqp_problem(seed):
    """Two lanes near the arm's pose, with wrench hypotheses."""
    rng = np.random.default_rng(seed)
    xs = np.r_[INIT_Q, np.zeros(6)] + rng.normal(size=(SQP_B, 12)) * 0.05
    goals = rng.normal(size=(SQP_B, SQP_N, 3)) * 0.3
    X = xs[:, None, :] + rng.normal(size=(SQP_B, SQP_N, 12)) * 0.05
    U = rng.normal(size=(SQP_B, SQP_N - 1, 6)) * 0.5
    w = rng.normal(size=(SQP_B, 6)) * 8
    w[:, 3:] = 0.0
    return xs, goals, X, U, w


def assert_sqp_equal(got, want, tol=1e-8):
    """Discrete choices exactly, X and U to ``tol`` after scaling each lane
    by max(1, max |value|): the joint torques in U reach ~1e2, and an
    iterative backend that runs to its cap in float64 carries rounding of
    ~1e-16 relative through its iterations."""
    np.testing.assert_array_equal(got.stats.alphas.numpy(), np.asarray(want.stats.alphas))
    np.testing.assert_array_equal(got.stats.iterations.numpy(),
                                  np.asarray(want.stats.iterations))
    if want.stats.pcg_iters is None:
        assert got.stats.pcg_iters is None
    else:
        np.testing.assert_array_equal(got.stats.pcg_iters.numpy(),
                                      np.asarray(want.stats.pcg_iters))
    assert_lanes_close(got.X.numpy(), want.X, "X", tol=tol)
    assert_lanes_close(got.U.numpy(), want.U, "U", tol=tol)
    np.testing.assert_allclose(got.state.rho.numpy(), np.asarray(want.state.rho), rtol=1e-6)


def test_sqp_solve_pscan_matches_jax():
    sqp_cfg = cfg.SQPConfig(max_iters=2, qp_backend="riccati_pscan")
    xs, goals, X, U, w = sqp_problem(8)
    model = jax_indy7(dtype=jnp.float64)
    want = jax.jit(lambda *a: jsqp.batch_solve(
        model, jcfg.CostConfig(), sqp_cfg, DT, *a[:4], wrench_world_batch=a[4]))(
        xs, goals, X, U, w)
    t = torch.as_tensor
    got = sqp.solve(indy7(torch.float64), cfg.CostConfig(), sqp_cfg, DT, t(xs), t(goals),
                    t(X), t(U), wrench_world=t(w))
    assert want.stats.pcg_iters is None
    assert_sqp_equal(got, want)
    assert got.state.admm_z is None and got.state.admm_y is None

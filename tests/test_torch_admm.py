"""The port's OSQP-style ADMM (``ops/admm.py``) against the TPU package's,
on the CPU in float64.

  * ``solve``'s X, U, multipliers y, primal iterate z and iteration
    counts, cold and warm-started (``z0``/``y0``), for one lane and for
    lanes batched against ``jax.vmap``: lanes of different rho, one lane's
    gradients scaled by 1e3 (OSQP's infinity-norm exit runs over one lane,
    so the lanes stop at their own iteration);
  * the SQP solve with ``qp_backend="admm"`` against the JAX solver, N=8,
    B=2, 2 SQP iterations, over two chained calls, so that the warm start
    carried in ``SolverState.admm_z``/``admm_y`` is held;
  * ``run_mpc`` on ADMM against the JAX ``run_mpc`` for 3 steps (the warm
    start carried across ticks);
  * float32 solved in float64, a deliberate deviation (ROADMAP section 3).

Tolerance 1e-9 after scaling each lane by max(1, max |value|) on the op,
1e-8 on the SQP solve and the loop; iteration counts exactly.  Each JAX
program is jitted once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jcfg
from indy7_mpc_tpu.dynamics import ee_pos as jax_ee_pos
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.mpc import run_mpc as jax_run_mpc
from indy7_mpc_tpu.ops import admm as jadmm
from indy7_mpc_tpu.solvers import sqp as jsqp
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.mpc import run_mpc
from indy7_mpc_tpu_torch.ops import admm
from indy7_mpc_tpu_torch.solvers import sqp
from test_torch_riccati_pscan import (
    DT, INIT_Q, RHO, assert_lanes_close, assert_sqp_equal, jax_blocks, port_blocks,
    random_lanes, sqp_problem,
)

N, MAX_ITERS = 8, 400
ADMM = cfg.SQPConfig(max_iters=2, qp_backend="admm")


@pytest.fixture(scope="module")
def jax_admm():
    """(batched, warm) -> the JAX solve, jitted once."""
    cold = lambda b, xs, rho: jadmm.solve(b, xs, rho, max_iters=MAX_ITERS)
    warm = lambda b, xs, rho, z0, y0: jadmm.solve(b, xs, rho, max_iters=MAX_ITERS,
                                                  z0=z0, y0=y0)
    fns = {(batched, w): jax.jit(jax.vmap(f) if batched else f)
           for batched in (False, True) for w, f in ((False, cold), (True, warm))}
    return lambda batched, w: fns[batched, w]


def _check(got, want, lanes):
    for name in ("X", "U", "y", "z"):
        assert_lanes_close(getattr(got, name).numpy(), getattr(want, name), name, lanes=lanes)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    assert got.iterations.dtype == torch.int32


@pytest.mark.parametrize("batched", [False, True], ids=["one_lane", "batched"])
def test_admm_matches_jax_cold_and_warm(jax_admm, batched):
    """A cold solve, then a warm one from its (z, y) on nearby blocks (the
    next SQP iteration's QP)."""
    blocks, xs = random_lanes(31, N)
    rng = np.random.default_rng(32)
    nearby = tuple(a * (1.0 + 0.01 * rng.normal(size=a.shape)) for a in blocks)
    lane = None if batched else 1
    sel = (lambda a: a) if batched else (lambda a: a[1])
    rho = RHO if batched else float(RHO[1])
    jrho = jnp.asarray(rho)
    prho = torch.as_tensor(rho) if batched else rho

    want = jax_admm(batched, False)(jax_blocks(blocks, lane), jnp.asarray(sel(xs)), jrho)
    got = admm.solve(port_blocks(blocks, lane), torch.as_tensor(sel(xs)), prho,
                     max_iters=MAX_ITERS)
    _check(got, want, batched)
    if batched:
        assert len(set(got.iterations.tolist())) > 1, got.iterations

    want2 = jax_admm(batched, True)(jax_blocks(nearby, lane), jnp.asarray(sel(xs)), jrho,
                                    want.z, want.y)
    got2 = admm.solve(port_blocks(nearby, lane), torch.as_tensor(sel(xs)), prho,
                      max_iters=MAX_ITERS, z0=got.z, y0=got.y)
    _check(got2, want2, batched)
    assert (got2.iterations < got.iterations).all()  # the warm start pays
    for name in ("r_prim", "r_dual"):
        np.testing.assert_allclose(getattr(got2, name).numpy(), np.asarray(getattr(want2, name)),
                                   rtol=1e-6, atol=1e-12)


def test_admm_runs_to_max_iters():
    """A tolerance no lane reaches: every lane runs exactly max_iters."""
    blocks, xs = random_lanes(33, N)
    got = admm.solve(port_blocks(blocks), torch.as_tensor(xs), torch.as_tensor(RHO),
                     eps_abs=0.0, eps_rel=0.0, max_iters=5)
    np.testing.assert_array_equal(got.iterations.numpy(), [5, 5, 5])


def test_admm_float32_solves_in_float64():
    """float32 blocks give the float64 solve of the rounded blocks, rounded
    (in float32 the iteration diverges on Gauss-Newton blocks)."""
    blocks, xs = random_lanes(34, N)
    f32 = [torch.as_tensor(a, dtype=torch.float32) for a in blocks]
    rho = torch.as_tensor(RHO, dtype=torch.float32)
    xs32 = torch.as_tensor(xs, dtype=torch.float32)
    got = admm.solve(port_blocks(f32), xs32, rho)
    want = admm.solve(port_blocks([a.double() for a in f32]), xs32.double(), rho.double())
    for g, w in zip(got, want):
        if g.is_floating_point():
            assert g.dtype == torch.float32
            w = w.float()
        assert torch.equal(g, w)


def test_sqp_solve_admm_matches_jax_over_chained_calls():
    """Two calls, the second warm-started from the first's state; the JAX
    side gets zeros for the first call's warm start, which is its cold
    start."""
    xs, goals, X, U, w = sqp_problem(10)
    model = jax_indy7(dtype=jnp.float64)
    jfn = jax.jit(lambda st, *a: jsqp.batch_solve(
        model, jcfg.CostConfig(), ADMM, DT, *a[:4], state=st, wrench_world_batch=a[4]))
    B, nz = xs.shape[0], 18
    st0 = jsqp.SolverState(rho=jnp.full(B, ADMM.rho, jnp.float32),
                           admm_z=jnp.zeros((B, N, nz)), admm_y=jnp.zeros((B, N, 12)))
    want1 = jfn(st0, xs, goals, X, U, w)
    want2 = jfn(want1.state, xs, goals, np.asarray(want1.X), np.asarray(want1.U), w)

    t = torch.as_tensor
    model_t = indy7(torch.float64)
    got1 = sqp.solve(model_t, cfg.CostConfig(), ADMM, DT, t(xs), t(goals), t(X), t(U),
                     wrench_world=t(w))
    got2 = sqp.solve(model_t, cfg.CostConfig(), ADMM, DT, t(xs), t(goals), got1.X, got1.U,
                     state=got1.state, wrench_world=t(w))
    for got, want in ((got1, want1), (got2, want2)):
        assert_sqp_equal(got, want)
        assert_lanes_close(got.state.admm_z.numpy(), want.state.admm_z, "admm_z", tol=1e-8)
        assert_lanes_close(got.state.admm_y.numpy(), want.state.admm_y, "admm_y", tol=1e-8)
        assert (got.stats.pcg_iters[:, 0] > 0).all()


def test_run_mpc_admm_matches_jax():
    """Point to goal on ADMM for 3 steps: the solver state, ADMM's warm
    start included, carried across ticks under the alive mask."""
    model = jax_indy7(dtype=jnp.float64)
    x0 = np.r_[INIT_Q, np.zeros(6)]
    ee0 = np.asarray(jax_ee_pos(model, jnp.asarray(x0[:6])))
    endpoints = np.stack([ee0 + [0.02, 0.0, -0.02], ee0 + [-0.05, 0.05, -0.05]])
    mpc = cfg.MPCConfig(N=N, dt=DT)
    final, jt = jax.jit(lambda x: jax_run_mpc(
        model, jcfg.CostConfig(), ADMM, mpc, x, endpoints, 3))(jnp.asarray(x0))
    pf, pt = run_mpc(indy7(torch.float64), cfg.CostConfig(), ADMM, mpc, torch.as_tensor(x0),
                     endpoints, 3)
    for f in ("x", "u", "goal_dist"):
        assert_lanes_close(getattr(pt, f).numpy(), getattr(jt, f), f, lanes=False, tol=1e-8)
    np.testing.assert_array_equal(pt.sqp_iters.numpy(), np.asarray(jt.sqp_iters))
    for f in ("x", "X", "U"):
        assert_lanes_close(getattr(pf, f).numpy(), getattr(final, f), f, lanes=False, tol=1e-8)
    for f in ("admm_z", "admm_y"):
        assert_lanes_close(getattr(pf.state, f).numpy(), getattr(final.state, f), f,
                           lanes=False, tol=1e-8)

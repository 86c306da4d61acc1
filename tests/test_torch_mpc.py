"""The single-lane loops of the port (``run_mpc``, ``run_tracking_mpc``;
the SQP kernel's plain version at B = 1 and the tick epilogue's plain
version as the plant) against the TPU package's on its readable solver,
float64 on the CPU.

Each JAX loop is jitted once.  Both sides run the same Gauss-Newton SQP
and RK4 arithmetic in f64, so states and controls agree to 1e-8 over the
few ticks run here (the solvers agree to ~1e-9 per solve).  ``sqp_iters``
differs by design where a step is rejected (the port counts accepted
steps), so the port's count is held at or below the JAX count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jcfg
from indy7_mpc_tpu.dynamics import ee_pos as jax_ee_pos
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.mpc import reference as jax_reference
from indy7_mpc_tpu.mpc import run_mpc as jax_run_mpc
from indy7_mpc_tpu.mpc.tracking import run_tracking_mpc as jax_run_tracking_mpc
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.mpc import run_mpc, run_tracking_mpc
from indy7_mpc_tpu_torch.solvers.select import default_single_solve_fn

N, DT, STEPS, ATOL = 8, 0.01, 6, 1e-8
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
WRENCH = [5.0, 0.0, 15.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("cost, sqp", [
    (cfg.CostConfig(), cfg.SQPConfig(qp_backend="pcg")),
    (cfg.CostConfig(), cfg.SQPConfig(qp_backend="admm")),
    (cfg.CostConfig(), cfg.SQPConfig(qp_backend="riccati_pscan")),
    (cfg.CostConfig(formulation="reference"), cfg.SQPConfig()),
], ids=["pcg", "admm", "riccati_pscan", "reference"])
def test_single_solve_selector_raises_outside_kernel_coverage(cost, sqp):
    """The loops' single-lane solver is K1 (or its plain version) inside
    its coverage (formulation 'gn' with the Riccati backend).  Outside it
    (formulation 'reference', or the QP backends pcg, admm and
    riccati_pscan) it is the readable solver: the same bits as
    ``solvers.sqp.solve`` (held against the JAX solver in
    tests/test_torch_readable.py), and for the QP backends also the JAX
    selection's result (its readable solver on the CPU), to 1e-8 after
    scaling by max(1, max |value|), the bound of the backends' own tests."""
    from indy7_mpc_tpu.solvers import select as jax_select
    from indy7_mpc_tpu_torch.solvers import sqp as sqp_mod

    model = indy7(torch.float64)
    fn = default_single_solve_fn(model, cost, sqp, DT)
    rng = np.random.default_rng(4)
    xs = torch.as_tensor(np.r_[INIT_Q, np.zeros(6)])
    goals = torch.as_tensor(rng.normal(size=(N, 3)) * 0.3)
    X = torch.as_tensor(rng.normal(size=(N, 12)) * 0.05)
    U = torch.as_tensor(rng.normal(size=(N - 1, 6)))
    got = fn(xs, goals, X, U)
    want = sqp_mod.solve(model, cost, sqp, DT, xs, goals, X, U)
    for g, w in zip(got, want):
        for a, b in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert got.stats.iterations.shape == () and got.X.shape == (N, 12)
    if sqp.qp_backend == "riccati":
        return
    jfn = jax_select.default_single_solve_fn(jax_indy7(dtype=jnp.float64), cost, sqp, DT)
    jres = jax.jit(jfn)(*(jnp.asarray(a.numpy()) for a in (xs, goals, X, U)))
    np.testing.assert_array_equal(got.stats.alphas.numpy(), np.asarray(jres.stats.alphas))
    if sqp.qp_backend in ("pcg", "admm"):
        np.testing.assert_array_equal(got.stats.pcg_iters.numpy(),
                                      np.asarray(jres.stats.pcg_iters))
    for a, b in ((got.X, jres.X), (got.U, jres.U)):
        b = np.asarray(b)
        assert (np.abs(a.numpy() - b) / max(1.0, np.abs(b).max())).max() <= 1e-8


def _close(port, jax_value, name):
    np.testing.assert_allclose(
        port.numpy(), np.asarray(jax_value), rtol=0, atol=ATOL, err_msg=name
    )


def test_run_mpc_matches_jax():
    """Point to goal: a goal chain near the start pose so the goal switches
    within the run, a true wrench on the plant, rho carried across solves."""
    model = jax_indy7(dtype=jnp.float64)
    x0 = np.r_[INIT_Q, np.zeros(6)]
    ee0 = np.asarray(jax_ee_pos(model, jnp.asarray(x0[:6])))
    endpoints = np.stack([ee0 + [0.02, 0.0, -0.02], ee0 + [-0.05, 0.05, -0.05]])
    sqp, mpc = jcfg.SQPConfig(max_iters=2), jcfg.MPCConfig(N=N, dt=DT)
    final, jt = jax.jit(lambda x: jax_run_mpc(
        model, jcfg.CostConfig(), sqp, mpc, x, endpoints, STEPS,
        wrench_world=jnp.asarray(WRENCH),
    ))(jnp.asarray(x0))

    pf, pt = run_mpc(
        indy7(torch.float64), cfg.CostConfig(), cfg.SQPConfig(max_iters=2),
        cfg.MPCConfig(N=N, dt=DT), torch.as_tensor(x0), endpoints, STEPS,
        wrench_world=torch.tensor(WRENCH, dtype=torch.float64),
    )
    np.testing.assert_array_equal(pt.goal_idx.numpy(), np.asarray(jt.goal_idx))
    assert np.asarray(jt.goal_idx)[-1] != 0  # the goal switched
    for f in ("x", "u", "goal_dist"):
        _close(getattr(pt, f), getattr(jt, f), f)
    assert (pt.sqp_iters.numpy() <= np.asarray(jt.sqp_iters)).all()
    for f in ("x", "X", "U"):
        _close(getattr(pf, f), getattr(final, f), f)
    assert bool(pf.alive) and bool(final.alive)
    assert int(pf.goal_idx) == int(final.goal_idx)
    np.testing.assert_allclose(float(pf.state.rho), float(final.state.rho), rtol=1e-6)


def test_run_tracking_mpc_matches_jax():
    """fig-8 tracking with a wrench on the plant that the solver models."""
    model = jax_indy7(dtype=jnp.float64)
    ref = jax_reference.with_padding(jax_reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)[196:]
    x0 = np.r_[INIT_Q, np.zeros(6)]
    sqp, mpc = jcfg.SQPConfig(max_iters=1), jcfg.MPCConfig(N=N, dt=DT)
    final, jt = jax.jit(lambda x: jax_run_tracking_mpc(
        model, jcfg.CostConfig(), sqp, mpc, x, ref, STEPS,
        wrench_world=jnp.asarray(WRENCH), solver_wrench=jnp.asarray(WRENCH),
    ))(jnp.asarray(x0))

    pf, pt = run_tracking_mpc(
        indy7(torch.float64), cfg.CostConfig(), cfg.SQPConfig(max_iters=1),
        cfg.MPCConfig(N=N, dt=DT), torch.as_tensor(x0), ref, STEPS,
        wrench_world=torch.tensor(WRENCH, dtype=torch.float64),
        solver_wrench=torch.tensor(WRENCH, dtype=torch.float64),
    )
    for f in ("tracking_error", "ee_pos", "ee_ref", "q", "u"):
        _close(getattr(pt, f), getattr(jt, f), f)
    assert (pt.sqp_iters.numpy() <= np.asarray(jt.sqp_iters)).all()
    for f in ("x", "X", "U"):
        _close(getattr(pf, f), getattr(final, f), f)
    assert int(pf.ref_offset) == int(final.ref_offset) == STEPS

"""The port's readable solver and readable plant against the TPU
package's, on the CPU.

  * ``solvers/sqp.solve`` and ``batch_solve`` against the JAX readable
    solver for both formulations, with wrench hypotheses and lanes whose
    warm starts are absurd enough to be rejected, float64: X and U to
    1e-9 (rtol 1e-5 on the extreme lanes' ~1e4 values), alphas,
    iterations run and rho equal;
  * the float32 readable solver against the port's plain K1 at the 3e-3
    of tests/test_lane_sqp.py;
  * ``solvers/select``'s fallback for formulation="reference" (and its
    warning for a card) and for the QP backends outside K1's coverage;
  * ``sim/readable_plant.py`` and the readable consensus against the JAX
    plant and ``find_best_lane``, and the MJCF plant's infinite velocity
    limits.

The readable ticks and the controller on them are held against the JAX
loop in tests/test_torch_readable_loop.py (a file of its own, so that the
two sets of JAX compiles run on different test workers).  Each JAX
program is jitted once per module.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jcfg
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.solvers import sqp as jsqp
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch.models import indy7, indy7_mjcf
from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
from indy7_mpc_tpu_torch.solvers import select, sqp, sqp_lane

B, N, DT = 4, 8, 0.01
SQP_ITERS = 2
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]


def _problem(seed, dtype=np.float64):
    """Lanes 0-1 near the arm's pose, lanes 2-3 with states and warm
    starts scaled far past the linearization's validity (their steps get
    rejected), as in tests/test_torch_sqp.py."""
    rng = np.random.default_rng(seed)
    x_scale = np.array([0.05, 0.05, 60.0, 160.0])
    u_scale = np.array([0.5, 0.5, 6e3, 1.6e4])
    xs = rng.normal(size=(B, 12)) * x_scale[:, None]
    goals = rng.normal(size=(B, N, 3)) * 0.3
    X = rng.normal(size=(B, N, 12)) * x_scale[:, None, None]
    U = rng.normal(size=(B, N - 1, 6)) * u_scale[:, None, None]
    w = rng.normal(size=(B, 6)) * 8
    w[:, 3:] = 0.0
    rho = np.array([1e-6, 1e-4, 1e-6, 1e-6], np.float32)
    return [a.astype(dtype) for a in (xs, goals, X, U, w)] + [rho]


@pytest.fixture(scope="module")
def jax_solvers():
    """formulation -> the JAX readable batch solve, jitted once."""
    model = jax_indy7(dtype=jnp.float64)
    out = {}
    for form in ("gn", "reference"):
        cost = jcfg.CostConfig(formulation=form)
        fn = jax.jit(lambda xs, g, X, U, w, rho, cost=cost: jsqp.batch_solve(
            model, cost, jcfg.SQPConfig(max_iters=SQP_ITERS), DT, xs, g, X, U,
            state=jsqp.SolverState(rho=rho), wrench_world_batch=w))
        out[form] = fn
    return out


def _assert_solve_equal(got, want):
    """Discrete choices exactly; X and U to 1e-9 on lanes 0-1 and to rtol
    1e-5 on the extreme lanes 2-3, whose values reach ~1e4 far outside the
    linearization's validity, where the two packages' summation orders
    differ by ~1e-6 relative after the conditioning of the sweep."""
    np.testing.assert_array_equal(got.stats.alphas.numpy(), np.asarray(want.stats.alphas))
    np.testing.assert_array_equal(got.stats.iterations.numpy(),
                                  np.asarray(want.stats.iterations))
    np.testing.assert_array_equal(got.state.rho.numpy(), np.asarray(want.state.rho))
    assert got.state.rho.dtype == torch.float32
    for name in ("X", "U"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(g[:2], w[:2], rtol=0, atol=1e-9, err_msg=name)
        np.testing.assert_allclose(g[2:], w[2:], rtol=1e-5, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(got.stats.step_sizes.numpy(), np.asarray(want.stats.step_sizes),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("formulation", ["gn", "reference"])
def test_readable_solver_matches_jax(jax_solvers, formulation):
    xs, goals, X, U, w, rho = _problem(5)
    want = jax_solvers[formulation](xs, goals, X, U, w, rho)
    alphas = np.asarray(want.stats.alphas)
    assert (alphas == 0.0).any() and (alphas > 0.0).any(), "no rejection: test ineffective"
    t = torch.as_tensor
    cost = cfg.CostConfig(formulation=formulation)
    sqp_cfg = cfg.SQPConfig(max_iters=SQP_ITERS)
    got = sqp.batch_solve(indy7(torch.float64), cost, sqp_cfg, DT, t(xs), t(goals), t(X), t(U),
                          state=sqp.SolverState(rho=t(rho)), wrench_world_batch=t(w))
    _assert_solve_equal(got, want)
    # The rejected lanes' iterations count, as in the JAX solver.
    assert (got.stats.iterations.numpy() == SQP_ITERS).all()
    # One lane without a batch dim: solve() gives that lane's result.
    one = sqp.solve(indy7(torch.float64), cost, sqp_cfg, DT, t(xs[1]), t(goals[1]), t(X[1]),
                    t(U[1]), state=sqp.SolverState(rho=t(rho[1])), wrench_world=t(w[1]))
    np.testing.assert_allclose(one.X.numpy(), got.X[1].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(one.stats.alphas.numpy(), got.stats.alphas[1].numpy())
    assert one.stats.iterations.shape == ()


def test_readable_solver_float32_matches_plain_k1():
    """f32: the readable solver (its Riccati sweep upcast to f64) against
    the plain version of kernel K1 (its sweep in f32) on the lanes near
    the pose: alphas equal, X and U to 3e-3."""
    xs, goals, X, U, w, _ = _problem(9, np.float32)
    t = lambda a: torch.as_tensor(a[:2])
    args = (indy7(torch.float32), cfg.CostConfig(), cfg.SQPConfig(max_iters=SQP_ITERS), DT,
            t(xs), t(goals), t(X), t(U))
    got = sqp.batch_solve(*args, wrench_world_batch=t(w))
    want = sqp_lane.batch_solve(*args, wrench_world_batch=t(w))
    assert got.X.dtype == torch.float32
    np.testing.assert_array_equal(got.stats.alphas.numpy(), want.stats.alphas.numpy())
    for name in ("X", "U"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                   rtol=0, atol=3e-3, err_msg=name)


def test_select_falls_back_to_readable_solver(jax_solvers, caplog):
    """formulation="reference" selects the readable solver on any device
    (K1 covers "gn" only); a card logs the fallback, the CPU does not."""
    model = indy7(torch.float64)
    cost, sqp_cfg = cfg.CostConfig(formulation="reference"), cfg.SQPConfig(max_iters=SQP_ITERS)
    assert select.kernel_supports(cfg.CostConfig(), sqp_cfg)
    assert not select.kernel_supports(cost, sqp_cfg)
    assert select.is_cuda_device("cuda:0") and not select.is_cuda_device("cpu")
    with caplog.at_level(logging.WARNING, logger="indy7_mpc_tpu_torch.solvers.select"):
        fn = select.default_batch_solve_fn(model, cost, sqp_cfg, DT, device="cpu")
        single = select.default_single_solve_fn(model, cost, sqp_cfg, DT, device="cpu")
    assert not caplog.records
    with caplog.at_level(logging.WARNING, logger="indy7_mpc_tpu_torch.solvers.select"):
        select.default_batch_solve_fn(model, cost, sqp_cfg, DT, device="cuda")
        select.default_single_solve_fn(model, cost, sqp_cfg, DT, device="cuda")
    assert len(caplog.records) == 2
    assert all("readable solver" in r.getMessage() for r in caplog.records)

    xs, goals, X, U, w, rho = _problem(5)
    want = jax_solvers["reference"](xs, goals, X, U, w, np.full(B, sqp_cfg.rho, np.float32))
    t = torch.as_tensor
    before = sqp_solve.launches
    _assert_solve_equal(fn(t(xs), t(goals), t(X), t(U), t(w)), want)
    res = single(t(xs[0]), t(goals[0]), t(X[0]), t(U[0]), wrench_world=t(w[0]))
    np.testing.assert_allclose(res.X.numpy(), np.asarray(want.X[0]), rtol=0, atol=1e-9)
    assert sqp_solve.launches == before


@pytest.mark.parametrize("backend", ["pcg", "admm", "riccati_pscan"])
def test_unported_qp_backends_raise(backend):
    """The QP backends the port once lacked run now: both selectors give
    the readable solver on them, finite, with lane 0 of the batched solve
    equal to the single-lane solve to 1e-9 (scaled by max(1, max |value|));
    an unknown backend name raises ValueError in the selectors and the
    solver.  Each backend against JAX: tests/test_torch_{pcg,admm,
    riccati_pscan}.py."""
    sqp_cfg = cfg.SQPConfig(qp_backend=backend)
    model = indy7(torch.float64)
    xs, goals, X, U, w, _ = (torch.as_tensor(a) for a in _problem(6))
    batched = select.default_batch_solve_fn(model, cfg.CostConfig(), sqp_cfg, DT)(
        xs, goals, X, U, w)
    single = select.default_single_solve_fn(model, cfg.CostConfig(), sqp_cfg, DT)(
        xs[0], goals[0], X[0], U[0], wrench_world=w[0])
    assert (batched.stats.pcg_iters is None) == (backend == "riccati_pscan")
    for b, s in ((batched.X, single.X), (batched.U, single.U)):
        assert bool(torch.isfinite(b).all())
        assert ((b[0] - s).abs().max() / s.abs().max().clamp(min=1.0)).item() <= 1e-9
    np.testing.assert_array_equal(batched.stats.alphas[0].numpy(), single.stats.alphas.numpy())

    bogus = cfg.SQPConfig(qp_backend="cholesky")
    z = torch.zeros(12, dtype=torch.float64)
    for make in (select.default_batch_solve_fn, select.default_single_solve_fn):
        with pytest.raises(ValueError, match="unknown qp_backend"):
            make(model, cfg.CostConfig(), bogus, DT)
    with pytest.raises(ValueError, match="unknown qp_backend"):
        sqp.solve(model, cfg.CostConfig(), bogus, DT, z, torch.zeros(N, 3, dtype=z.dtype),
                  torch.zeros(N, 12, dtype=z.dtype), torch.zeros(N - 1, 6, dtype=z.dtype))


def test_mjcf_plant_keeps_infinite_velocity_limits():
    """The MJCF has no velocity limits: +inf reaches K2's ctypes constants
    unchanged, and velocity saturation on the plain plant changes no bit."""
    import dataclasses
    import math

    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels import _abi
    from indy7_mpc_tpu_torch.sim.plant import perturb_model, plant_step

    for dtype in (torch.float32, torch.float64):
        smp = LR.static_model(perturb_model(indy7_mjcf(dtype), cfg.PERTURBED_PLANT))
        assert all(math.isinf(v) and v > 0 for v in _abi.model_consts(smp).velocity_limit)
        assert _abi.plant_params(dataclasses.replace(cfg.PERTURBED_PLANT,
                                                     velocity_saturation=True),
                                 DT, B, True).velocity_saturation == 1
        x = torch.as_tensor(np.r_[INIT_Q[:5], 3.7, 30.0 * np.ones(6)], dtype=dtype)[:, None]
        u = torch.full((6, 1), 50.0, dtype=dtype)
        a, b = (plant_step(smp, x, u, DT, substeps=5, velocity_saturation=sat)
                for sat in (True, False))
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("saturation", [False, True])
def test_readable_plant_matches_jax_and_lane_plant(saturation):
    """``sim/readable_plant.py`` against the JAX plant (its noise draws
    replayed) and against the lane-major plant (K2's plain version), f64:
    a batch of three states, one fast and past a joint stop, under world
    wrenches, friction and three noisy substeps."""
    from indy7_mpc_tpu.sim import plant as jplant
    from indy7_mpc_tpu_torch.mpc.readable_tick import readable_consensus
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.sim import plant as lane_plant
    from indy7_mpc_tpu_torch.sim import readable_plant

    rng = np.random.default_rng(8)
    x = np.stack([np.r_[INIT_Q, 0.3 * rng.normal(size=6)] for _ in range(3)])
    x[2] = np.r_[INIT_Q[:5], 3.8, 4.0 * np.ones(6)]
    u = rng.normal(size=(3, 6)) * 30.0
    w = rng.normal(size=(3, 6)) * 10.0
    friction, substeps, std = (0.05, 0.1), 3, 0.1
    key = jax.random.PRNGKey(5)
    normals, k = [], key
    for _ in range(substeps):
        k, ks = jax.random.split(k)
        normals.append(np.asarray(jax.random.normal(ks, (3, 6), jnp.float64)))
    noise = std * np.stack(normals)  # (substeps, 3, 6): one draw per state
    jmodel = jax_indy7(dtype=jnp.float64)
    want = jax.jit(lambda x_, u_, w_, k_: jplant.plant_step(
        jmodel, x_, u_, DT, wrench_world=w_, substeps=substeps, friction=friction,
        torque_noise_std=std, key=k_, velocity_saturation=saturation))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(w), key)
    model = indy7(torch.float64)
    t = torch.as_tensor
    got = readable_plant.plant_step(model, t(x), t(u), DT, wrench_world=t(w), substeps=substeps,
                                    friction=friction, noise=t(noise),
                                    velocity_saturation=saturation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
    lane = lane_plant.plant_step(LR.static_model(model), t(x.T), t(u.T), DT,
                                 wrench_world=t(w.T), substeps=substeps, friction=friction,
                                 noise=t(noise.transpose(0, 2, 1)),
                                 velocity_saturation=saturation)
    np.testing.assert_allclose(got.numpy(), lane.T.numpy(), rtol=0, atol=1e-10)

    # The consensus on the readable plant against the JAX find_best_lane.
    from indy7_mpc_tpu.mpc.sampled import find_best_lane as jax_find_best_lane

    best, err = readable_consensus(model, t(x[0]), t(u[0]), t(x[1]), DT, t(w))
    jbest, jerr = jax.jit(lambda *a: jax_find_best_lane(jmodel, *a[:3], DT, a[3]))(
        jnp.asarray(x[0]), jnp.asarray(u[0]), jnp.asarray(x[1]), jnp.asarray(w))
    assert int(best) == int(jbest)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=0, atol=1e-10)

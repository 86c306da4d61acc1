"""The port's QP blocks (``ops/kkt.py``), Riccati sweep (``ops/riccati.py``)
and merit terms against the TPU package's, and the sweep against the dense
KKT oracle (``ops/dense_kkt.py``), float64 on the CPU.

The same seeded numpy trajectories (B = 3 lanes, N = 8; one lane rides
its joint limits, so the barrier is active there) go through the JAX
function, vmapped over lanes and jitted once per case, and through the
port, which takes the lanes as a leading batch dim.  Tolerances are those
of tests/test_lane_sqp.py: A and Q to 1e-11, B to 1e-12, the sweep to 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indy7_mpc_tpu.config import CostConfig as JCostConfig
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.ops import dense_kkt as jdense
from indy7_mpc_tpu.ops import kkt as jkkt
from indy7_mpc_tpu.ops import riccati as jriccati
from indy7_mpc_tpu.solvers import sqp as jsqp
from indy7_mpc_tpu_torch.config import CostConfig
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.ops import dense_kkt, kkt, riccati
from indy7_mpc_tpu_torch.solvers import sqp

B, N, DT = 3, 8, 0.01
ATOL = {"A": 1e-11, "B": 1e-12, "c": 1e-11, "Q": 1e-11, "q": 1e-11, "R": 1e-11, "r": 1e-11}


@pytest.fixture(scope="module")
def models():
    return indy7(torch.float64), jax_indy7(dtype=jnp.float64)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(B, N, 12)) * 0.05
    X[2, :, 0] = 3.0   # inside joint 0's barrier band (limit 3.054, margin 0.1)
    X[2, :, 4] = -3.02
    U = rng.normal(size=(B, N - 1, 6)) * 0.5
    goals = rng.normal(size=(B, N, 3)) * 0.3
    w = rng.normal(size=(B, 6)) * 8
    w[:, 3:] = rng.normal(size=(B, 3))
    return {"X": X, "U": U, "goals": goals, "w": w, "rho": np.array([1e-6, 1e-3, 0.1])}


def _t(p):
    return {k: torch.as_tensor(v) for k, v in p.items()}


def _build(formulation):
    return {"gn": (kkt.build_qp_gn, jkkt.build_qp_gn),
            "reference": (kkt.build_qp, jkkt.build_qp)}[formulation]


@pytest.mark.parametrize("wrench", [True, False], ids=["wrench", "no_wrench"])
@pytest.mark.parametrize("formulation", ["gn", "reference"])
def test_build_qp_matches_jax(models, problem, formulation, wrench):
    model, jmodel = models
    port_fn, jax_fn = _build(formulation)
    cost = CostConfig(formulation=formulation)
    jcost = JCostConfig(formulation=formulation)
    t = _t(problem)
    w = t["w"] if wrench else None
    got = port_fn(model, cost, t["X"], t["U"], t["goals"], DT, wrench_world=w)
    if wrench:
        want = jax.vmap(lambda X, U, g, w: jax_fn(
            jmodel, jcost, X, U, g, DT, wrench_world=w))(
            problem["X"], problem["U"], problem["goals"], problem["w"])
    else:
        want = jax.vmap(lambda X, U, g: jax_fn(jmodel, jcost, X, U, g, DT))(
            problem["X"], problem["U"], problem["goals"])
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=ATOL[name], err_msg=name)
    # One lane without a batch dim gives that lane's blocks.
    one = port_fn(model, cost, t["X"][1], t["U"][1], t["goals"][1], DT,
                  wrench_world=None if w is None else w[1])
    for name in got._fields:
        np.testing.assert_allclose(getattr(one, name).numpy(), getattr(got, name)[1].numpy(),
                                   rtol=0, atol=1e-13, err_msg=name)


def test_linearize_with_local_wrench_matches_jax(models, problem):
    """The ``f_ext_ee`` path: a local EE wrench held along the horizon."""
    model, jmodel = models
    t = _t(problem)
    got = kkt.linearize_dynamics(model, t["X"], t["U"], DT, f_ext_ee=t["w"])
    want = jax.vmap(lambda X, U, f: jkkt.linearize_dynamics(
        jmodel, X, U, DT, f_ext_ee=f))(problem["X"], problem["U"], problem["w"])
    for g, w_, atol in zip(got, want, (1e-11, 1e-12, 1e-11)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0, atol=atol)


def test_riccati_matches_jax_and_dense_kkt(models, problem):
    """The sweep against the JAX sweep (per-lane rho) and, lane by lane,
    against the dense KKT solve of both packages."""
    model, jmodel = models
    t = _t(problem)
    blocks = kkt.build_qp_gn(model, CostConfig(), t["X"], t["U"], t["goals"], DT,
                             wrench_world=t["w"])
    xs = torch.as_tensor(np.random.default_rng(2).normal(size=(B, 12)) * 0.01)
    sol = riccati.solve(blocks, xs, t["rho"])
    jblocks = jkkt.QPBlocks(*(jnp.asarray(b.numpy()) for b in blocks))
    want = jax.jit(jax.vmap(jriccati.solve))(jblocks, jnp.asarray(xs.numpy()),
                                             jnp.asarray(problem["rho"]))
    for name in sol._fields:
        np.testing.assert_allclose(getattr(sol, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-9, err_msg=name)
    for lane in range(B):
        lane_blocks = kkt.QPBlocks(*(b[lane] for b in blocks))
        Xd, Ud = dense_kkt.solve(lane_blocks, xs[lane], float(problem["rho"][lane]))
        np.testing.assert_allclose(sol.X[lane].numpy(), Xd, rtol=0, atol=1e-9)
        np.testing.assert_allclose(sol.U[lane].numpy(), Ud, rtol=0, atol=1e-9)
        Xj, Uj = jdense.solve(jkkt.QPBlocks(*(b[lane] for b in jblocks)),
                              xs[lane].numpy(), float(problem["rho"][lane]))
        np.testing.assert_array_equal(Xd, Xj)
        np.testing.assert_array_equal(Ud, Uj)


def test_riccati_upcasts_float32(models, problem):
    """float32 blocks are swept in float64 and cast back, always."""
    model, _ = models
    t = _t(problem)
    blocks = kkt.build_qp_gn(model, CostConfig(), t["X"], t["U"], t["goals"], DT)
    b32 = kkt.QPBlocks(*(b.float() for b in blocks))
    xs = torch.zeros(B, 12, dtype=torch.float32)
    got = riccati.solve(b32, xs, t["rho"].float())
    want = riccati.solve(kkt.QPBlocks(*(b.double() for b in b32)), xs.double(),
                         t["rho"].float().double())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w.float().numpy())


@pytest.mark.parametrize("formulation", ["gn", "reference"])
def test_merit_terms_match_jax(models, problem, formulation):
    """eepos_cost (the barrier in "gn" only), the integrator error, the
    defects, the barrier terms and the merit, per lane."""
    model, jmodel = models
    cost, jcost = CostConfig(formulation=formulation), JCostConfig(formulation=formulation)
    t = _t(problem)
    x0 = t["X"][:, 0] + 0.01

    def port(X, U, g, w, x0_):
        return (*kkt.eepos_cost(model, cost, X, U, g),
                kkt.integrator_err(model, X, U, DT, wrench_world=w),
                kkt.dynamics_defects(model, X, U, DT, wrench_world=w),
                *kkt.barrier_terms(model, cost, X[..., :6]),
                sqp.merit(model, cost, 10.0, X, U, g, x0_, DT, wrench_world=w))

    def jax_fn(X, U, g, w, x0_):
        return (*jkkt.eepos_cost(jmodel, jcost, X, U, g),
                jkkt.integrator_err(jmodel, X, U, DT, wrench_world=w),
                jkkt.dynamics_defects(jmodel, X, U, DT, wrench_world=w),
                *jax.vmap(lambda q: jkkt.barrier_terms(jmodel, jcost, q))(X[:, :6]),
                jsqp.merit(jmodel, jcost, 10.0, X, U, g, x0_, DT, wrench_world=w))

    got = port(t["X"], t["U"], t["goals"], t["w"], x0)
    want = jax.jit(jax.vmap(jax_fn))(problem["X"], problem["U"], problem["goals"],
                                     problem["w"], x0.numpy())
    names = ("qcost", "vcost", "ucost", "integrator_err", "defects", "barrier_val",
             "barrier_grad", "barrier_hess", "merit")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-10,
                                   err_msg=name)
    assert float(got[5][2].sum()) > 0.0  # the barrier is active on lane 2

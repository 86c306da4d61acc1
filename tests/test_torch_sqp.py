"""SQP kernel K1 of the PyTorch port: its wrapper and plain version on the
CPU against the TPU package's readable solver (``solvers/sqp.py``), f64.

Both sides run in float64 on the CPU, so the discrete line-search choices
must agree exactly and the trajectories to 1e-9, the f64 bound between the
lane solver and the readable solver (tests/test_lane_sqp.py).  The JAX
oracle is jitted once per module with fixed shapes; a zero wrench stands
in for "no wrench" so that one compile serves every case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indy7_mpc_tpu.config import CostConfig, SQPConfig
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.solvers import sqp as jax_sqp
from indy7_mpc_tpu.solvers.sqp import SolverState as JaxSolverState
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
from indy7_mpc_tpu_torch.solvers import sqp_cuda, sqp_lane
from indy7_mpc_tpu_torch.solvers.select import default_batch_solve_fn

B, N, DT = 8, 8, 0.01
COST = CostConfig()
SQP = SQPConfig(max_iters=2)
ATOL = 1e-9


@pytest.fixture(scope="module")
def oracle():
    model = jax_indy7(dtype=jnp.float64)
    fn = jax.jit(
        lambda xs, g, X, U, w, rho: jax_sqp.batch_solve(
            model, COST, SQP, DT, xs, g, X, U,
            state=JaxSolverState(rho=rho), wrench_world_batch=w,
        )
    )

    def run(xs, g, X, U, w, rho):
        res = fn(xs, g, X, U, w, rho)
        return {
            "X": np.asarray(res.X), "U": np.asarray(res.U),
            "rho": np.asarray(res.state.rho, np.float64),
            "alphas": np.asarray(res.stats.alphas),
            "steps": np.asarray(res.stats.step_sizes),
        }

    return run


@pytest.fixture(scope="module")
def sm():
    return LR.static_model(indy7(torch.float64))


def _problem(seed, x_scale=0.05, u_scale=0.5, wrench=True):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, 12)) * x_scale
    goals = rng.normal(size=(B, N, 3)) * 0.3
    X = rng.normal(size=(B, N, 12)) * x_scale
    U = rng.normal(size=(B, N - 1, 6)) * u_scale
    w = rng.normal(size=(B, 6)) * 8 if wrench else np.zeros((B, 6))
    w[:, 3:] = 0.0
    return xs, goals, X, U, w


def _fresh_rho():
    return np.full(B, SQP.rho, np.float32)


def _lane_major(sm, xs, goals, X, U, w, rho, wrench):
    """The port's lane-major wrapper on CPU tensors; B-major numpy out."""
    t = torch.tensor  # a copy: the JAX outputs fed back in are read-only
    Xo, Uo, rho_o, alphas, steps = sqp_solve(
        sm, COST, SQP, DT, t(xs.T), t(goals.transpose(1, 2, 0)),
        t(X.transpose(1, 2, 0)), t(U.transpose(1, 2, 0)),
        wrench=t(w.T) if wrench else None, rho=t(rho),
    )
    return {
        "X": Xo.permute(2, 0, 1).numpy(), "U": Uo.permute(2, 0, 1).numpy(),
        "rho": rho_o.numpy(), "alphas": alphas.T.numpy(), "steps": steps.T.numpy(),
    }


def _assert_match(got, ref, rtol=0.0):
    np.testing.assert_array_equal(got["alphas"], ref["alphas"])
    for k in ("X", "U", "rho", "steps"):
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("wrench", [True, False])
def test_sqp_solve_matches_jax(oracle, sm, wrench):
    xs, goals, X, U, w = _problem(5, wrench=wrench)
    ref = oracle(xs, goals, X, U, w, _fresh_rho())
    before = sqp_solve.launches
    got = _lane_major(sm, xs, goals, X, U, w, _fresh_rho(), wrench)
    _assert_match(got, ref)
    assert sqp_solve.launches == before  # CPU tensors: the plain version

    # The B-major plain solver and the kernel-backed B-major solver agree too.
    t = torch.as_tensor
    for res in (
        sqp_lane.batch_solve(
            indy7(torch.float64), COST, SQP, DT, t(xs), t(goals), t(X), t(U),
            wrench_world_batch=t(w) if wrench else None,
        ),
        default_batch_solve_fn(indy7(torch.float64), COST, SQP, DT)(
            t(xs), t(goals), t(X), t(U), t(w) if wrench else None
        ),
    ):
        np.testing.assert_array_equal(res.stats.alphas.numpy(), ref["alphas"])
        np.testing.assert_allclose(res.X.numpy(), ref["X"], rtol=0, atol=ATOL)
        np.testing.assert_allclose(res.U.numpy(), ref["U"], rtol=0, atol=ATOL)
    assert sqp_solve.launches == before


def test_sqp_warm_started_second_solve(oracle, sm):
    """The closed loop's steady state: the first solve's trajectory and
    rho fed back in."""
    xs, goals, X, U, w = _problem(17)
    ref1 = oracle(xs, goals, X, U, w, _fresh_rho())
    got1 = _lane_major(sm, xs, goals, X, U, w, _fresh_rho(), True)
    _assert_match(got1, ref1)
    rho1 = ref1["rho"].astype(np.float32)
    ref2 = oracle(xs, goals, ref1["X"], ref1["U"], w, rho1)
    got2 = _lane_major(sm, xs, goals, ref1["X"], ref1["U"], w, rho1, True)
    _assert_match(got2, ref2)


def test_sqp_rejection_escalates_rho(oracle, sm):
    """Warm starts ramped from mild to absurd: rejected iterations raise
    rho by rho_factor and leave the trajectory at the warm start.  The
    line-search choices and rho still match exactly; the trajectories
    reach ~1e6 far outside the linearization's validity, where the two
    Riccati implementations' summation orders differ by ~1e-8 relative,
    so X and U are held to rtol 1e-6."""
    xs, goals, X, U, w = _problem(3, x_scale=1.0, u_scale=100.0)
    ramp = np.linspace(1.0, 160.0, B)
    X, U, xs = X * ramp[:, None, None], U * ramp[:, None, None], xs * ramp[:, None]
    ref = oracle(xs, goals, X, U, w, _fresh_rho())
    rejected = (ref["alphas"] == 0.0).any(axis=1)
    assert rejected.any(), "no lane rejected: test ineffective"
    assert (ref["rho"][rejected] > SQP.rho * 1.5).all()
    got = _lane_major(sm, xs, goals, X, U, w, _fresh_rho(), True)
    _assert_match(got, ref, rtol=1e-6)


def test_sqp_cuda_batch_solve_counts_accepted_steps(sm):
    xs, goals, X, U, w = _problem(3, x_scale=1.0, u_scale=100.0)
    ramp = np.linspace(1.0, 160.0, B)
    t = torch.as_tensor
    res = sqp_cuda.batch_solve(
        indy7(torch.float64), COST, SQP, DT, t(xs * ramp[:, None]), t(goals),
        t(X * ramp[:, None, None]), t(U * ramp[:, None, None]),
        wrench_world_batch=t(w),
    )
    accepted = (res.stats.alphas > 0).sum(1)
    np.testing.assert_array_equal(res.stats.iterations.numpy(), accepted.numpy())


@pytest.mark.parametrize(
    "cost, sqp",
    [(COST, SQPConfig(qp_backend="pcg")), (CostConfig(formulation="reference"), SQP)],
    ids=["pcg", "reference"],
)
def test_sqp_solve_raises_outside_kernel_coverage(sm, cost, sqp):
    """The wrapper itself refuses what neither the kernel nor its plain
    version implements, before it looks at the device."""
    xs, goals, X, U, w = _problem(5)
    t = torch.tensor
    with pytest.raises(ValueError, match="riccati"):
        sqp_solve(
            sm, cost, sqp, DT, t(xs.T), t(goals.transpose(1, 2, 0)),
            t(X.transpose(1, 2, 0)), t(U.transpose(1, 2, 0)), wrench=t(w.T),
        )


@pytest.mark.parametrize("case", ["reference", "pcg", "admm", "riccati_pscan"])
def test_select_raises_outside_kernel_coverage(case):
    """Outside K1's coverage (formulation="reference", or the QP backends
    pcg, admm and riccati_pscan) the port selects the readable solver, the
    same bits as ``solvers/sqp.batch_solve``, which matches the TPU
    package's selection (its readable solver on the CPU): discrete choices
    exactly; X and U to 1e-9 under "reference", and under the QP backends
    to 1e-8 after scaling each lane by max(1, max |value|), the bound of
    the backends' own tests (PCG runs to its iteration cap on these QPs,
    ADMM factors H with a condition number near rho_admm / sigma = 1e9)."""
    from indy7_mpc_tpu.solvers import select as jax_select
    from indy7_mpc_tpu_torch.solvers import sqp as readable

    if case == "reference":
        cost, sqp = CostConfig(formulation="reference"), SQPConfig(max_iters=1)
    else:
        cost, sqp = COST, SQPConfig(max_iters=1, qp_backend=case)
    xs, goals, X, U, w = _problem(5)
    want = jax.jit(jax_select.default_batch_solve_fn(
        jax_indy7(dtype=jnp.float64), cost, sqp, DT))(xs, goals, X, U, w)
    t = torch.as_tensor
    before = sqp_solve.launches
    got = default_batch_solve_fn(indy7(torch.float64), cost, sqp, DT)(
        t(xs), t(goals), t(X), t(U), t(w))
    assert sqp_solve.launches == before
    same = readable.batch_solve(indy7(torch.float64), cost, sqp, DT, t(xs), t(goals), t(X),
                                t(U), wrench_world_batch=t(w))
    for a, b in ((got.X, same.X), (got.U, same.U), (got.stats.alphas, same.stats.alphas)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got.stats.alphas.numpy(), np.asarray(want.stats.alphas))
    np.testing.assert_array_equal(got.stats.iterations.numpy(),
                                  np.asarray(want.stats.iterations))
    if case in ("pcg", "admm"):
        np.testing.assert_array_equal(got.stats.pcg_iters.numpy(),
                                      np.asarray(want.stats.pcg_iters))
    else:
        assert got.stats.pcg_iters is None and want.stats.pcg_iters is None
    for g, wv in ((got.X, want.X), (got.U, want.U)):
        wv = np.asarray(wv)
        if case == "reference":
            np.testing.assert_allclose(g.numpy(), wv, rtol=0, atol=ATOL)
        else:
            scale = np.maximum(1.0, np.abs(wv).max(axis=(1, 2), keepdims=True))
            assert (np.abs(g.numpy() - wv) / scale).max() <= 1e-8

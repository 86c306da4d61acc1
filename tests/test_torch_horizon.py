"""K1 past one block's shared memory: the port against the TPU package at a
horizon of 180 knots, which the kernel holds in a cluster of two blocks
(the TPU kernel takes any N), float64 on the CPU.

The solve goes through ``sqp_solve`` on CPU tensors (the plain version,
``solvers/sqp_lane.py``) against the TPU package's readable solver at 1
SQP iteration, at 8 and at 20 line-search alphas; the closed loop is
``run_sampled_mpc`` against the TPU package's readable tick
(``make_loop_tick(fused=False)``) with each tick's draws replayed from the
JAX carry's key, as tests/test_torch_slice.py does at N=8.  Tolerances are
those of the N=8 tests: equal alphas and 1e-9 for the solve
(tests/test_torch_sqp.py), the best lanes equal and 1e-8 for the loop
(tests/test_torch_slice.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jcfg
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.mpc import reference as jax_reference
from indy7_mpc_tpu.mpc.sampled import init_loop_carry, make_loop_tick
from indy7_mpc_tpu.solvers import sqp as jax_sqp
from indy7_mpc_tpu.solvers.sqp import SolverState as JaxSolverState
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.models.convert import carry_from_numpy
from indy7_mpc_tpu_torch.mpc import TickDraws, reference, run_sampled_mpc
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.ops.kernels import sqp_kernel as K1
from indy7_mpc_tpu_torch.roofline import k1_work

B, N, DT, TICKS = 2, 180, 0.01, 3
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]
SOLVE_ATOL, LOOP_ATOL = 1e-9, 1e-8


def test_horizon_needs_a_cluster():
    """N=180 is past one block (174 knots) and within a cluster of two."""
    assert N > K1.MAX_SEGMENT
    assert K1.check_horizon(N) == (2, K1.shared_bytes(90))
    assert K1.check_horizon(N, 20) == (2, K1.shared_bytes(90, 20))


@pytest.mark.parametrize("num_alphas", [8, 20])
def test_sqp_solve_matches_jax_past_one_block(num_alphas):
    """One SQP iteration at N=180, B=2, with a wrench, from seeded inputs."""
    sqp_j = jcfg.SQPConfig(max_iters=1, num_alphas=num_alphas)
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(B, 12)) * 0.05
    goals = rng.normal(size=(B, N, 3)) * 0.3
    X = rng.normal(size=(B, N, 12)) * 0.05
    U = rng.normal(size=(B, N - 1, 6)) * 0.5
    w = rng.normal(size=(B, 6)) * 8
    w[:, 3:] = 0.0
    rho = np.full(B, sqp_j.rho, np.float32)
    model = jax_indy7(dtype=jnp.float64)
    res = jax.jit(lambda *a: jax_sqp.batch_solve(
        model, jcfg.CostConfig(), sqp_j, DT, *a[:4],
        state=JaxSolverState(rho=a[5]), wrench_world_batch=a[4],
    ))(xs, goals, X, U, w, rho)

    t = torch.tensor
    sm = LR.static_model(indy7(torch.float64))
    before = K1.sqp_solve.launches
    Xo, Uo, rho_o, alphas, steps = K1.sqp_solve(
        sm, cfg.CostConfig(), cfg.SQPConfig(max_iters=1, num_alphas=num_alphas), DT,
        t(xs.T), t(goals.transpose(1, 2, 0)), t(X.transpose(1, 2, 0)),
        t(U.transpose(1, 2, 0)), wrench=t(w.T), rho=t(rho),
    )
    assert K1.sqp_solve.launches == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(alphas.T.numpy(), np.asarray(res.stats.alphas))
    for name, got, want in (
        ("X", Xo.permute(2, 0, 1), res.X), ("U", Uo.permute(2, 0, 1), res.U),
        ("rho", rho_o, res.state.rho), ("steps", steps.T, res.stats.step_sizes),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64), rtol=0,
                                   atol=SOLVE_ATOL, err_msg=name)


def _replay_draws(key, plant_cfg):
    """One tick's draws, exactly as the readable tick consumes its key
    (tests/test_torch_slice.py's replay at B lanes)."""
    _, k_tick, k_walk, k_plant = jax.random.split(key, 4)
    key_r, _ = jax.random.split(k_tick)
    draws, k = [], k_plant
    for _ in range(plant_cfg.substeps):
        k, ks = jax.random.split(k)
        draws.append(np.asarray(jax.random.normal(ks, (6,), jnp.float64)))
    return TickDraws(
        resample=torch.tensor(np.asarray(jax.random.normal(key_r, (B, 6), jnp.float64))),
        walk=torch.tensor(np.asarray(jax.random.normal(k_walk, (3,), jnp.float64))),
        plant=torch.as_tensor(np.stack(draws)),
    )


def test_closed_loop_matches_jax_past_one_block():
    """A few ticks of the sampled loop at N=180, B=2 on the perturbed
    plant, the goals moving (the run starts 198 rows into the padded
    fig-8)."""
    ref = reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)[198:]
    np.testing.assert_array_equal(ref, jax_reference.with_padding(jax_reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)[198:])
    model = jax_indy7(dtype=jnp.float64)
    tick = jax.jit(make_loop_tick(
        model, jcfg.CostConfig(), jcfg.SQPConfig(max_iters=2), jcfg.MPCConfig(N=N, dt=DT),
        jcfg.SampleConfig(batch_size=B), jnp.asarray(ref), plant_cfg=jcfg.PERTURBED_PLANT,
        fused=False,
    ))
    x0 = np.r_[INIT_Q, np.zeros(6)]
    carry = init_loop_carry(
        model, jcfg.MPCConfig(N=N, dt=DT), jcfg.SampleConfig(batch_size=B),
        jnp.asarray(x0), jnp.asarray(F_TRUE0), jax.random.PRNGKey(42),
    )
    carry0 = carry_from_numpy({f: np.asarray(getattr(carry, f)) for f in carry._fields})
    draws, traces = [], []
    for _ in range(TICKS):
        draws.append(_replay_draws(carry.key, jcfg.PERTURBED_PLANT))
        carry, trace = tick(carry, None)
        traces.append(trace)
    jt = {f: np.stack([np.asarray(getattr(t, f)) for t in traces]) for f in traces[0]._fields}

    final, pt = run_sampled_mpc(
        indy7(torch.float64), cfg.CostConfig(), cfg.SQPConfig(max_iters=2),
        cfg.MPCConfig(N=N, dt=DT), cfg.SampleConfig(batch_size=B),
        torch.as_tensor(x0), ref, TICKS, F_TRUE0, None,
        plant_cfg=cfg.PERTURBED_PLANT, carry0=carry0, draws=draws,
    )
    np.testing.assert_array_equal(pt.best_idx.numpy(), jt["best_idx"])
    for f in ("x", "u", "tracking_error", "f_est", "f_true", "ee_pos", "ee_ref"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), jt[f], rtol=0, atol=LOOP_ATOL,
                                   err_msg=f)
    for f in ("x", "f_batch", "f_true", "X_best", "U_best"):
        np.testing.assert_allclose(getattr(final, f).numpy(), np.asarray(getattr(carry, f)),
                                   rtol=0, atol=LOOP_ATOL, err_msg=f)


def test_k1_work_is_affine_in_the_horizon():
    """roofline.k1_work prices every knot alike, so N=256 and 512 (two and
    three blocks a lane) are priced as N=64 is: flops and bytes affine in
    N at fixed B."""
    at = {n: k1_work(64, n) for n in (64, 128, 256, 512)}
    for i in (0, 1):
        assert at[512][i] - at[256][i] == 2 * (at[256][i] - at[128][i]) == 4 * (
            at[128][i] - at[64][i])

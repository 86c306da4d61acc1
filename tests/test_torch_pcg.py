"""The port's dual Schur-complement PCG (``ops/pcg.py``) against the TPU
package's, on the CPU in float64.

  * ``build_schur``'s blocks, and ``solve``'s X, U, multipliers and CG
    iteration counts, for one lane and for lanes batched against
    ``jax.vmap``: lanes of different rho, one lane's gradients scaled by
    1e3 (a reduction across lanes would change every lane's exit), each
    lane stopping at its own iteration;
  * the SQP solve with ``qp_backend="pcg"`` against the JAX solver, N=8,
    B=2, 2 SQP iterations, ``pcg_iters`` included.

Tolerance 1e-9 after scaling each lane by max(1, max |value|) on the op,
1e-8 on the SQP solve; iteration counts exactly.  Each JAX program is
jitted once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jcfg
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.ops import pcg as jpcg
from indy7_mpc_tpu.solvers import sqp as jsqp
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.ops import pcg
from indy7_mpc_tpu_torch.solvers import sqp
from test_torch_riccati_pscan import (
    DT, RHO, assert_lanes_close, assert_sqp_equal, jax_blocks, port_blocks, random_lanes,
    sqp_problem,
)

N, REG, PCG_TOL, MAX_ITERS = 8, 1e-4, 1e-6, 200


@pytest.fixture(scope="module")
def jax_pcg():
    """batched -> the JAX (build_schur, solve), jitted once."""
    def one(b, xs, rho):
        return (jpcg.build_schur(b, rho, REG),
                jpcg.solve(b, xs, rho, primal_reg=REG, tol=PCG_TOL, max_iters=MAX_ITERS))

    fns = {False: jax.jit(one), True: jax.jit(jax.vmap(one))}
    return lambda batched: fns[batched]


def _check(got_schur, got, want_schur, want, lanes):
    for i, (g, w) in enumerate(zip(got_schur, want_schur)):
        assert_lanes_close(g.numpy(), w, f"build_schur[{i}]", lanes=lanes)
    for name in ("X", "U", "lam"):
        assert_lanes_close(getattr(got, name).numpy(), getattr(want, name), name, lanes=lanes)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    assert got.iterations.dtype == torch.int32


def test_pcg_matches_jax_one_lane(jax_pcg):
    blocks, xs = random_lanes(21, N)
    want_schur, want = jax_pcg(False)(jax_blocks(blocks, 0), jnp.asarray(xs[0]), RHO[0])
    pb = port_blocks(blocks, 0)
    got_schur = pcg.build_schur(pb, float(RHO[0]), REG)
    got = pcg.solve(pb, torch.as_tensor(xs[0]), float(RHO[0]), primal_reg=REG, tol=PCG_TOL,
                    max_iters=MAX_ITERS)
    assert 0 < int(got.iterations) < MAX_ITERS
    _check(got_schur, got, want_schur, want, lanes=False)
    np.testing.assert_allclose(float(got.residual), float(want.residual), rtol=1e-6, atol=1e-12)


def test_pcg_matches_jax_batched(jax_pcg):
    blocks, xs = random_lanes(22, N)
    want_schur, want = jax_pcg(True)(jax_blocks(blocks), jnp.asarray(xs), jnp.asarray(RHO))
    pb, prho = port_blocks(blocks), torch.as_tensor(RHO)
    got_schur = pcg.build_schur(pb, prho, REG)
    got = pcg.solve(pb, torch.as_tensor(xs), prho, primal_reg=REG, tol=PCG_TOL,
                    max_iters=MAX_ITERS)
    _check(got_schur, got, want_schur, want, lanes=True)
    its = got.iterations.numpy()
    assert (its > 0).all() and (its < MAX_ITERS).all()
    assert len(set(its.tolist())) > 1, its  # lanes stop at their own iteration


def test_pcg_runs_to_max_iters():
    """A tolerance no lane reaches: every lane runs exactly max_iters."""
    blocks, xs = random_lanes(23, N)
    got = pcg.solve(port_blocks(blocks), torch.as_tensor(xs), torch.as_tensor(RHO),
                    primal_reg=REG, tol=0.0, max_iters=7)
    np.testing.assert_array_equal(got.iterations.numpy(), [7, 7, 7])


def test_sqp_solve_pcg_matches_jax():
    """The GATO method in the SQP loop: the default PCG settings."""
    sqp_cfg = cfg.SQPConfig(max_iters=2, qp_backend="pcg")
    xs, goals, X, U, w = sqp_problem(9)
    model = jax_indy7(dtype=jnp.float64)
    want = jax.jit(lambda *a: jsqp.batch_solve(
        model, jcfg.CostConfig(), sqp_cfg, DT, *a[:4], wrench_world_batch=a[4]))(
        xs, goals, X, U, w)
    t = torch.as_tensor
    got = sqp.solve(indy7(torch.float64), cfg.CostConfig(), sqp_cfg, DT, t(xs), t(goals),
                    t(X), t(U), wrench_world=t(w))
    assert_sqp_equal(got, want)
    assert got.stats.pcg_iters.shape == (2, 2) and got.stats.pcg_iters.dtype == torch.int32
    assert (got.stats.pcg_iters[:, 0] > 0).all()

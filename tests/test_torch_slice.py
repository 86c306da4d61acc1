"""The whole slice: the port's closed loop (``run_sampled_mpc`` on the
two-kernel tick, plain versions on the CPU) against the TPU package's
readable tick (``make_loop_tick(fused=False)``), float64.

The JAX tick is jitted once per plant configuration and stepped in a
Python loop.  Its initial carry is carried over to the port, and before
each tick the test replays that tick's draws from the JAX carry's key (the
key split of the tick, the resampling key, the walk key and the plant's
per-substep split chain) and hands them to the port.  Both sides then run
the same arithmetic in f64, up to the solvers' 1e-9 agreement.
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
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.models.convert import carry_from_numpy
from indy7_mpc_tpu_torch.mpc import TickDraws, reference, run_sampled_mpc
from indy7_mpc_tpu_torch.mpc.fused_tick import reference_window

B, N, TICKS, DT = 8, 8, 5, 0.01
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]
ATOL = 1e-8
PLANTS = {"nominal": (None, None), "perturbed": (cfg.PERTURBED_PLANT, jcfg.PERTURBED_PLANT)}


def _ref():
    ref = reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1)
    np.testing.assert_array_equal(
        ref, jax_reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1)
    )
    # Start 198 rows in, so the 200-row padding ends inside the first
    # horizon window and the goals move during the run.
    return reference.with_padding(ref, 200)[198:]


def _replay_draws(key, plant_cfg):
    """One tick's draws, exactly as the readable tick consumes its key."""
    _, k_tick, k_walk, k_plant = jax.random.split(key, 4)
    key_r, _ = jax.random.split(k_tick)
    plant = None
    if plant_cfg is not None and plant_cfg.torque_noise_std:
        draws, k = [], k_plant
        for _ in range(plant_cfg.substeps):
            k, ks = jax.random.split(k)
            draws.append(np.asarray(jax.random.normal(ks, (6,), jnp.float64)))
        plant = torch.as_tensor(np.stack(draws))
    return TickDraws(
        resample=torch.tensor(np.asarray(jax.random.normal(key_r, (B, 6), jnp.float64))),
        walk=torch.tensor(np.asarray(jax.random.normal(k_walk, (3,), jnp.float64))),
        plant=plant,
    )


@pytest.mark.parametrize("plant", ["nominal", "perturbed"])
def test_closed_loop_matches_jax(plant):
    port_plant, jax_plant = PLANTS[plant]
    ref = _ref()
    model = jax_indy7(dtype=jnp.float64)
    tick = jax.jit(make_loop_tick(
        model, jcfg.CostConfig(), jcfg.SQPConfig(max_iters=2), jcfg.MPCConfig(N=N, dt=DT),
        jcfg.SampleConfig(batch_size=B), jnp.asarray(ref), plant_cfg=jax_plant, fused=False,
    ))
    x0 = np.r_[INIT_Q, np.zeros(6)]
    carry = init_loop_carry(
        model, jcfg.MPCConfig(N=N, dt=DT), jcfg.SampleConfig(batch_size=B),
        jnp.asarray(x0), jnp.asarray(F_TRUE0), jax.random.PRNGKey(42),
    )
    carry0 = carry_from_numpy({f: np.asarray(getattr(carry, f)) for f in carry._fields})
    draws, traces = [], []
    for _ in range(TICKS):
        draws.append(_replay_draws(carry.key, jax_plant))
        carry, trace = tick(carry, None)
        traces.append(trace)
    jt = {f: np.stack([np.asarray(getattr(t, f)) for t in traces]) for f in traces[0]._fields}

    final, pt = run_sampled_mpc(
        indy7(torch.float64), cfg.CostConfig(), cfg.SQPConfig(max_iters=2),
        cfg.MPCConfig(N=N, dt=DT), cfg.SampleConfig(batch_size=B),
        torch.as_tensor(x0), ref, TICKS, F_TRUE0, None,
        plant_cfg=port_plant, carry0=carry0, draws=draws,
    )
    np.testing.assert_array_equal(pt.best_idx.numpy(), jt["best_idx"])
    for f in ("x", "u", "tracking_error", "f_est", "f_true", "ee_pos", "ee_ref"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), jt[f], rtol=0, atol=ATOL, err_msg=f)
    for f in ("x", "f_batch", "f_true", "X_best", "U_best"):
        np.testing.assert_allclose(
            getattr(final, f).numpy(), np.asarray(getattr(carry, f)), rtol=0, atol=ATOL, err_msg=f
        )
    assert int(final.ref_offset) == int(carry.ref_offset) == TICKS
    # The walk keys on carry.ref_offset, which starts at 0, so it fired in
    # tick 0; the trace records f_true before each tick's walk.
    assert not np.array_equal(jt["f_true"][0], jt["f_true"][-1])


def test_reference_window_clamps_like_jax():
    """dynamic_slice_in_dim clamps the start to len - N: offset 8 of 10
    rows with N = 4 gives rows 6-9."""
    ref = np.arange(30.0).reshape(10, 3)
    for offset in (0, 3, 6, 8, 12):
        got = reference_window(torch.as_tensor(ref), torch.tensor(offset), 4).numpy()
        want = np.asarray(jax.lax.dynamic_slice_in_dim(jnp.asarray(ref), offset, 4, 0))
        np.testing.assert_array_equal(got, want)
    got = reference_window(torch.as_tensor(ref), torch.tensor(8), 4).numpy()
    np.testing.assert_array_equal(got, ref[6:10])

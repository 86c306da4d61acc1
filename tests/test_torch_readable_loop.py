"""The port's readable ticks against the TPU package's ``fused=False``
loop, and the controller on them, on the CPU.

  * ``run_sampled_mpc(fused=False)`` and ``run_sampled_mpc`` on the
    two-kernel tick with ``plant_model=indy7_mjcf()`` against the JAX
    ``fused=False`` loop, float64, with the JAX draws replayed as in
    tests/test_torch_slice.py; ``make_loop_tick``'s choice of tick;
  * ``SampledController`` with an injected ``batch_solve_fn`` against the
    JAX controller (float32), and a "reference"-formulation controller.

The JAX loop tick takes its plant model as an argument, so one compile
serves both plants.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jcfg
import indy7_mpc_tpu.runtime as jrt
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.models import indy7_mjcf as jax_indy7_mjcf
from indy7_mpc_tpu.mpc.sampled import init_loop_carry, make_loop_tick
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch.models import indy7, indy7_mjcf
from indy7_mpc_tpu_torch.models.convert import carry_from_numpy, controller_state_from_npz
from indy7_mpc_tpu_torch.mpc import (
    ReadableLoopTick, ReadableSampledTick, TickDraws, make_loop_tick as port_make_loop_tick,
    reference, run_sampled_mpc,
)
from indy7_mpc_tpu_torch.mpc.fused_tick import FusedLoopTick
from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
from indy7_mpc_tpu_torch.runtime import InProcessPlant, SampledController
from indy7_mpc_tpu_torch.solvers import sqp

B, N, DT = 4, 8, 0.01
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# The closed loop.
# ---------------------------------------------------------------------------

TICKS, LOOP_ITERS = 5, 1  # one SQP iteration halves the JAX tick's compile


def _ref():
    ref = reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT,
                            cycles=1)
    return reference.with_padding(ref, 200)[198:]  # the goals move within the run


def _replay_draws(key, plant_cfg):
    """One tick's draws, exactly as the readable JAX tick consumes its key
    (tests/test_torch_slice.py)."""
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


@pytest.fixture(scope="module")
def jax_loop():
    """plant name -> (carry0, draws, trace, final carry) of the JAX
    fused=False loop on the perturbed plant, one jit for both plants."""
    model = jax_indy7(dtype=jnp.float64)
    sample = jcfg.SampleConfig(batch_size=B)
    mpc = jcfg.MPCConfig(N=N, dt=DT)
    ref = jnp.asarray(_ref())
    tick = jax.jit(lambda carry, pm: make_loop_tick(
        model, jcfg.CostConfig(), jcfg.SQPConfig(max_iters=LOOP_ITERS), mpc, sample, ref,
        plant_cfg=jcfg.PERTURBED_PLANT, plant_model=pm, fused=False)(carry, None))
    out = {}
    for name, pm in (("default", model), ("mjcf", jax_indy7_mjcf(dtype=jnp.float64))):
        carry = init_loop_carry(model, mpc, sample, jnp.asarray(np.r_[INIT_Q, np.zeros(6)]),
                                jnp.asarray(F_TRUE0), jax.random.PRNGKey(42))
        carry0 = carry_from_numpy({f: np.asarray(getattr(carry, f)) for f in carry._fields})
        draws, traces = [], []
        for _ in range(TICKS):
            draws.append(_replay_draws(carry.key, jcfg.PERTURBED_PLANT))
            carry, trace = tick(carry, pm)
            traces.append(trace)
        jt = {f: np.stack([np.asarray(getattr(t, f)) for t in traces]) for f in traces[0]._fields}
        out[name] = (carry0, draws, jt, carry)
    return out


@pytest.mark.parametrize("plant, fused", [
    ("default", False), ("mjcf", False), ("mjcf", "auto"),
], ids=["readable-default_plant", "readable-mjcf_plant", "two_kernel-mjcf_plant"])
def test_closed_loop_matches_jax_readable_loop(jax_loop, plant, fused):
    """The port's loop against the JAX ``fused=False`` loop: the readable
    tick (its own solver, consensus and plant) and, on the MJCF plant, the
    two-kernel tick (the plain K1 and K2; K2 with the MJCF plant's
    constants, +inf velocity limits included).  Winners equal, the rest to
    1e-8 (the solvers' 1e-9 agreement carried through the plant)."""
    carry0, draws, jt, jfinal = jax_loop[plant]
    before = sqp_solve.launches
    final, pt = run_sampled_mpc(
        indy7(torch.float64), cfg.CostConfig(), cfg.SQPConfig(max_iters=LOOP_ITERS),
        cfg.MPCConfig(N=N, dt=DT), cfg.SampleConfig(batch_size=B),
        carry0.x, _ref(), TICKS, F_TRUE0, None, plant_cfg=cfg.PERTURBED_PLANT,
        plant_model=indy7_mjcf(torch.float64) if plant == "mjcf" else None,
        carry0=carry0, draws=draws, fused=fused,
    )
    assert sqp_solve.launches == before  # CPU tensors: no kernel launch
    np.testing.assert_array_equal(pt.best_idx.numpy(), jt["best_idx"])
    for f in ("x", "u", "tracking_error", "f_est", "f_true", "ee_pos", "ee_ref"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), jt[f], rtol=0, atol=1e-8, err_msg=f)
    for f in ("x", "f_batch", "f_true", "X_best", "U_best"):
        np.testing.assert_allclose(getattr(final, f).numpy(), np.asarray(getattr(jfinal, f)),
                                   rtol=0, atol=1e-8, err_msg=f)
    assert int(final.ref_offset) == TICKS


def test_make_loop_tick_selects_the_tick():
    args = (indy7(torch.float64), cfg.CostConfig(), cfg.SQPConfig(), cfg.MPCConfig(N=N, dt=DT),
            cfg.SampleConfig(batch_size=B), torch.as_tensor(_ref()))
    assert isinstance(port_make_loop_tick(*args), FusedLoopTick)
    assert isinstance(port_make_loop_tick(*args, fused=False), ReadableLoopTick)
    injected = port_make_loop_tick(*args, batch_solve_fn=lambda *a: None)
    assert isinstance(injected, ReadableLoopTick)
    ref_args = (args[0], cfg.CostConfig(formulation="reference")) + args[2:]
    assert isinstance(port_make_loop_tick(*ref_args), ReadableLoopTick)
    with pytest.raises(ValueError):
        port_make_loop_tick(*ref_args, fused=True)
    # The two-kernel tick runs K1: an injected solver is refused, not dropped.
    with pytest.raises(ValueError, match="no injected batch_solve_fn"):
        port_make_loop_tick(*args, fused=True, batch_solve_fn=lambda *a: None)


# ---------------------------------------------------------------------------
# The controller.
# ---------------------------------------------------------------------------

CTL_SQP = dict(max_iters=1)
CTL_SAMPLE = dict(batch_size=B, f_ext_std=5.0, f_ext_resample_std=0.0)
F_EXT = [3.0, 0.0, -5.0]


def _hold_ref(ticks):
    from indy7_mpc_tpu_torch.dynamics import ee_pos

    ee = ee_pos(indy7(torch.float64), torch.zeros(6, dtype=torch.float64)).numpy()
    return np.tile(ee, (ticks, 1)).astype(np.float32)


def _drive(ctl, plant, ticks):
    plant.send_wrench(ctl.f_ext_actual)
    us, best = [], []
    for _ in range(ticks):
        u, info = ctl.on_state(plant.recv_state().x, DT)
        plant.send_command(u)
        us.append(np.array(u))
        best.append(info["best_idx"])
    return np.asarray(us), np.asarray(best)


def test_controller_with_injected_solver_follows_jax(tmp_path):
    """The port's controller on an injected readable solver (the readable
    tick) against the JAX controller on its readable solver, float32, each
    on its nominal in-process plant from the same controller state."""
    ckpt = str(tmp_path / "ctl.npz")
    ref = _hold_ref(400)
    jmodel = jax_indy7(dtype=jnp.float32)
    jctl = jrt.SampledController(
        jmodel, jcfg.CostConfig(), jcfg.SQPConfig(**CTL_SQP), jcfg.MPCConfig(N=6, dt=DT),
        jcfg.SampleConfig(**CTL_SAMPLE), ref, f_ext_actual=F_EXT,
    )
    jctl.save_checkpoint(ckpt)
    ju, jbest = _drive(jctl, jrt.InProcessPlant(jmodel, np.zeros(12), DT), 6)

    calls = []
    model = indy7(torch.float32)
    sqp_cfg = cfg.SQPConfig(**CTL_SQP)

    def solver(xs, g, X, U, w):
        calls.append(xs.shape[0])
        return sqp.batch_solve(model, cfg.CostConfig(), sqp_cfg, DT, xs, g, X, U,
                               wrench_world_batch=w)

    ctl = SampledController(model, cfg.CostConfig(), sqp_cfg, cfg.MPCConfig(N=6, dt=DT),
                            cfg.SampleConfig(**CTL_SAMPLE), ref, batch_solve_fn=solver,
                            f_ext_actual=F_EXT, device="cpu")
    assert isinstance(ctl._tick.sampled, ReadableSampledTick)
    ctl.load_state(controller_state_from_npz(ckpt))
    before = sqp_solve.launches
    pu, pbest = _drive(ctl, InProcessPlant(model, np.zeros(12), DT, device="cpu"), 6)
    assert calls == [B] * 7  # the warm-up tick and six ticks
    assert sqp_solve.launches == before
    np.testing.assert_array_equal(pbest, jbest)
    np.testing.assert_allclose(pu, ju, rtol=0, atol=1e-4)


def test_reference_formulation_controller_runs_readable_tick():
    """A configuration outside K1's coverage routes the controller to the
    readable tick on the readable solver instead of raising."""
    ctl = SampledController(indy7(torch.float32), cfg.CostConfig(formulation="reference"),
                            cfg.SQPConfig(**CTL_SQP), cfg.MPCConfig(N=6, dt=DT),
                            cfg.SampleConfig(**CTL_SAMPLE), _hold_ref(50), f_ext_actual=F_EXT,
                            device="cpu")
    assert isinstance(ctl._tick.sampled, ReadableSampledTick)
    us, _ = _drive(ctl, InProcessPlant(indy7(torch.float32), np.zeros(12), DT, device="cpu"), 3)
    assert np.isfinite(us).all()

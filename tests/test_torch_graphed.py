"""The ticks on fixed buffers (``mpc/graphed.py``'s ``LoopTickRunner``,
``runtime/controller.py``'s ``ControllerTickRunner``): on a card they are
captured as CUDA graphs; here, on the CPU, the same bodies run eagerly.

  * the loop runner over 5 ticks against a Python loop over
    ``FusedLoopTick`` (float64): carry, trace and generator bit for bit;
  * the loop runner against the TPU package's ``run_sampled_mpc`` (its
    readable tick in one ``lax.scan``, float64) with the reference's draws
    injected: winners equal, the rest to 1e-8;
  * the controller's runner with the JAX controller's resampling normals
    injected against the JAX ``SampledController`` (float32, N=6, B=4, one
    SQP iteration), held as tests/test_torch_runtime.py holds the
    controller: winners equal, u within 1e-4, tracking error within 1e-5;
  * every buffer's address fixed over ticks, ``load``, ``reset_warm_start``
    and a checkpoint load (the graphs read those addresses).

Each JAX program is jitted once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jcfg
import indy7_mpc_tpu.runtime as jrt
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.mpc.sampled import init_loop_carry as jax_init_loop_carry
from indy7_mpc_tpu.mpc.sampled import run_sampled_mpc as jax_run_sampled_mpc
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.models.convert import carry_from_numpy, controller_state_from_npz
from indy7_mpc_tpu_torch.mpc import (
    TickDraws, init_loop_carry, make_loop_tick, reference, run_sampled_mpc,
)
from indy7_mpc_tpu_torch.mpc.graphed import LoopTickRunner
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.runtime import InProcessPlant, SampledController

B, N, TICKS, DT = 8, 8, 5, 0.01
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]
ATOL = 1e-8
# The controller's configuration (tests/test_runtime.py's), with the
# resampling on so that the injected normals matter.
CTL_B = 4
CTL = dict(mpc=dict(N=6, dt=DT), sqp=dict(max_iters=1),
           sample=dict(batch_size=CTL_B, f_ext_std=5.0, f_ext_resample_std=0.5))
F_EXT = [3.0, 0.0, -5.0]


def _ref():
    # 198 rows in: the 200-row padding ends inside the first window.
    return reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)[198:]


def _configs():
    return (cfg.CostConfig(), cfg.SQPConfig(max_iters=2), cfg.MPCConfig(N=N, dt=DT),
            cfg.SampleConfig(batch_size=B))


def _x0():
    return torch.as_tensor(np.r_[INIT_Q, np.zeros(6)])


def _replay_draws(key):
    """One tick's draws, exactly as the JAX readable tick consumes its key
    on the perturbed plant (tests/test_torch_slice.py's replay); returns
    (draws, the next tick's key)."""
    key, k_tick, k_walk, k_plant = jax.random.split(key, 4)
    key_r, _ = jax.random.split(k_tick)
    plant, k = [], k_plant
    for _ in range(cfg.PERTURBED_PLANT.substeps):
        k, ks = jax.random.split(k)
        plant.append(np.asarray(jax.random.normal(ks, (6,), jnp.float64)))
    return TickDraws(
        resample=torch.tensor(np.asarray(jax.random.normal(key_r, (B, 6), jnp.float64))),
        walk=torch.tensor(np.asarray(jax.random.normal(k_walk, (3,), jnp.float64))),
        plant=torch.as_tensor(np.stack(plant)),
    ), key


@pytest.mark.parametrize("source", ["generator", "draws"])
def test_loop_runner_equals_python_loop(source):
    """5 ticks on the runner's buffers, through ``run_sampled_mpc`` and
    through the runner in two runs (3 + 2 ticks, the carry kept in its
    buffers), against 5 calls of the tick module: the same bits."""
    model, ref = indy7(torch.float64), _ref()
    rng = np.random.default_rng(4)
    draws = None
    if source == "draws":
        draws = [TickDraws(torch.as_tensor(rng.normal(size=(B, 6))),
                           torch.as_tensor(rng.normal(size=3)),
                           torch.as_tensor(rng.normal(size=(cfg.PERTURBED_PLANT.substeps, 6))))
                 for _ in range(TICKS)]
    gens = [torch.Generator().manual_seed(3) for _ in range(3)]
    ticks = [make_loop_tick(model, *_configs(), torch.as_tensor(ref),
                            plant_cfg=cfg.PERTURBED_PLANT, generator=g) for g in gens]
    carries = [init_loop_carry(model, _configs()[2], _configs()[3], _x0(), F_TRUE0, g)
               for g in gens]

    rows, carry = [], carries[0]
    for t in range(TICKS):
        carry, row = ticks[0](carry, None if draws is None else draws[t])
        rows.append(row)
    want = {f: torch.stack([getattr(r, f) for r in rows]) for f in rows[0]._fields}

    final, trace = run_sampled_mpc(model, *_configs(), _x0(), ref, TICKS, F_TRUE0, gens[1],
                                   plant_cfg=cfg.PERTURBED_PLANT, carry0=carries[1],
                                   draws=draws)
    runner = LoopTickRunner(ticks[2], carries[2], rows=3, with_draws=draws is not None)
    parts = [runner.run(3, None if draws is None else draws[:3]),
             runner.run(2, None if draws is None else draws[3:])]
    for f in trace._fields:
        assert torch.equal(getattr(trace, f), want[f]), f
        assert torch.equal(torch.cat([getattr(p, f) for p in parts]), want[f]), f
    for f, a, b, c in zip(carry._fields, final, runner.carry(), carry):
        assert torch.equal(a, c) and torch.equal(b, c), f
    for g in gens[1:]:
        assert torch.equal(g.get_state(), gens[0].get_state())


def test_loop_runner_matches_jax_run_sampled_mpc():
    """The runner from the JAX initial carry with the JAX run's draws
    replayed from its key chain, against the TPU package's
    ``run_sampled_mpc`` (float64, the perturbed plant)."""
    ref = _ref()
    model = jax_indy7(dtype=jnp.float64)
    x0, key = np.r_[INIT_Q, np.zeros(6)], jax.random.PRNGKey(42)
    jcfgs = (jcfg.CostConfig(), jcfg.SQPConfig(max_iters=2), jcfg.MPCConfig(N=N, dt=DT),
             jcfg.SampleConfig(batch_size=B))
    final_j, trace_j = jax.jit(lambda x, r, f, k: jax_run_sampled_mpc(
        model, *jcfgs, x, r, TICKS, f, k, plant_cfg=jcfg.PERTURBED_PLANT,
    ))(jnp.asarray(x0), jnp.asarray(ref), jnp.asarray(F_TRUE0), key)
    carry = jax_init_loop_carry(model, jcfgs[2], jcfgs[3], jnp.asarray(x0),
                                jnp.asarray(F_TRUE0), key)
    carry0 = carry_from_numpy({f: np.asarray(getattr(carry, f)) for f in carry._fields})
    draws, k = [], carry.key
    for _ in range(TICKS):
        d, k = _replay_draws(k)
        draws.append(d)

    tick = make_loop_tick(indy7(torch.float64), *_configs(), torch.as_tensor(ref),
                          plant_cfg=cfg.PERTURBED_PLANT)
    runner = LoopTickRunner(tick, carry0, TICKS, with_draws=True)
    trace = runner.run(TICKS, draws)
    final = runner.carry()
    np.testing.assert_array_equal(trace.best_idx.numpy(), np.asarray(trace_j.best_idx))
    for f in ("x", "u", "tracking_error", "f_est", "f_true", "ee_pos", "ee_ref", "q"):
        np.testing.assert_allclose(getattr(trace, f).numpy(), np.asarray(getattr(trace_j, f)),
                                   rtol=0, atol=ATOL, err_msg=f)
    for f in ("x", "x_last", "u_last", "f_batch", "f_true", "X_best", "U_best"):
        np.testing.assert_allclose(getattr(final, f).numpy(), np.asarray(getattr(final_j, f)),
                                   rtol=0, atol=ATOL, err_msg=f)
    assert int(final.ref_offset) == int(final_j.ref_offset) == TICKS


def _addresses(tensors):
    return [t.data_ptr() for t in tensors]


def test_loop_runner_buffers_keep_their_addresses():
    model = indy7(torch.float64)
    gen = torch.Generator().manual_seed(1)
    tick = make_loop_tick(model, *_configs(), torch.as_tensor(_ref()),
                          plant_cfg=cfg.PERTURBED_PLANT, generator=gen)
    carry = init_loop_carry(model, _configs()[2], _configs()[3], _x0(), F_TRUE0, gen)
    runner = LoopTickRunner(tick, carry, rows=TICKS)
    runner.run(1)
    before = _addresses(runner.buffers())
    assert len(before) == len(carry) + 1 + len(runner.trace_bufs)
    runner.run(TICKS)
    runner.load(carry)
    assert _addresses(runner.buffers()) == before
    with pytest.raises(ValueError):  # another B: another runner
        runner.load(carry._replace(f_batch=torch.zeros(B + 1, 6, dtype=torch.float64)))
    with pytest.raises(ValueError):
        runner.run(TICKS + 1)


def _hold_ref(ticks):
    sm = LR.static_model(indy7(torch.float64))
    ee = torch.stack(LR.ee_pos(sm, list(torch.zeros(6, dtype=torch.float64)))).numpy()
    return np.tile(ee, (ticks, 1)).astype(np.float32)


def _controller(ref):
    return SampledController(
        indy7(torch.float32), cfg.CostConfig(), cfg.SQPConfig(**CTL["sqp"]),
        cfg.MPCConfig(**CTL["mpc"]), cfg.SampleConfig(**CTL["sample"]), ref,
        f_ext_actual=F_EXT, device="cpu",
    )


@pytest.fixture(scope="module")
def jax_controller_run(tmp_path_factory):
    """The JAX controller on its nominal in-process plant for 6 ticks, its
    state saved before the first; each tick's resampling normals replayed
    from its key (``k_next, k_tick = split(key)``; the normals from the
    first half of ``split(k_tick)``)."""
    ckpt = str(tmp_path_factory.mktemp("jax_ctl") / "ctl.npz")
    model = jax_indy7(dtype=jnp.float32)
    ref = _hold_ref(400)
    ctl = jrt.SampledController(
        model, jcfg.CostConfig(), jcfg.SQPConfig(**CTL["sqp"]), jcfg.MPCConfig(**CTL["mpc"]),
        jcfg.SampleConfig(**CTL["sample"]), ref, f_ext_actual=F_EXT,
    )
    ctl.save_checkpoint(ckpt)
    plant = jrt.InProcessPlant(model, np.zeros(12), DT)
    plant.send_wrench(ctl.f_ext_actual)
    normals, us, best, terr = [], [], [], []
    for _ in range(6):
        key_r, _ = jax.random.split(jax.random.split(ctl.key)[1])
        normals.append(np.array(jax.random.normal(key_r, (CTL_B, 6), jnp.float32)))
        u, info = ctl.on_state(plant.recv_state().x, DT)
        plant.send_command(u)
        us.append(np.array(u))
        best.append(info["best_idx"])
        terr.append(info["tracking_error"])
    return ckpt, ref, normals, (np.asarray(us), np.asarray(best), np.asarray(terr),
                                np.asarray(ctl.f_batch))


def test_controller_runner_matches_jax_controller(jax_controller_run):
    """The controller's runner stepped with the JAX ticks' normals, from
    the JAX controller's state, against its 6 ticks."""
    ckpt, ref, normals, (ju, jbest, jterr, jf_batch) = jax_controller_run
    ctl = _controller(ref)
    ctl.load_state(controller_state_from_npz(ckpt))
    plant = InProcessPlant(indy7(torch.float32), np.zeros(12), DT, device="cpu")
    plant.send_wrench(ctl.f_ext_actual)
    us, best, terr = [], [], []
    for n in normals:
        ctl.ref_offset += 1.0  # on_state's elapsed / dt
        host = ctl.runner.step(plant.recv_state().x, int(ctl.ref_offset),
                               normals=torch.as_tensor(n))
        plant.send_command(host[:6])
        us.append(host[:6])
        best.append(int(host[6]))
        terr.append(host[19])
    np.testing.assert_array_equal(best, jbest)
    np.testing.assert_allclose(np.asarray(us), ju, rtol=0, atol=1e-4)
    np.testing.assert_allclose(terr, jterr, atol=1e-5)
    np.testing.assert_allclose(ctl.f_batch.numpy(), jf_batch, rtol=0, atol=1e-4)


def test_controller_buffers_keep_their_addresses(tmp_path):
    ref = _hold_ref(400)
    ctl = _controller(ref)
    plant = InProcessPlant(indy7(torch.float32), np.zeros(12), DT, device="cpu")
    before = _addresses(ctl.runner.buffers())
    for _ in range(5):
        u, _ = ctl.on_state(plant.recv_state().x, DT)
        plant.send_command(u)
    assert _addresses(ctl.runner.buffers()) == before
    ckpt = ctl.save_checkpoint(str(tmp_path / "ctl.npz"))
    ctl.reset_warm_start()
    assert ctl.x_last is None and not ctl.X_best.any() and not ctl.u_last.any()
    assert _addresses(ctl.runner.buffers()) == before
    other = _controller(ref)
    other.load_checkpoint(ckpt)
    ctl.load_checkpoint(ckpt)
    assert _addresses(ctl.runner.buffers()) == before
    for name in ("X_best", "U_best", "f_batch", "x_last", "u_last"):
        assert torch.equal(getattr(ctl, name), getattr(other, name)), name

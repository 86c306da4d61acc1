"""The loops on ``mpc/graphed.py``'s ``TickRunner`` beyond the two-kernel
tick: ``run_mpc``, ``run_tracking_mpc``, the readable loop and the readable
controller tick.  On a card they replay captured CUDA graphs; here, on the
CPU, the runners run the same bodies eagerly.

  * ``run_mpc`` (K1's plain version, and the readable solver on ADMM with
    its warm start carried in ``SolverState``) and ``run_tracking_mpc``
    against a Python loop over the same tick (``make_mpc_tick``,
    ``make_tracking_tick``): trace and carry bit for bit; ``run_mpc`` on
    ADMM against the TPU package's (f64) at 1e-8 after scaling by
    max(1, max |value|), the iterative backends' bound;
  * ``run_sampled_mpc(fused=False)`` (the readable tick on the runner) on
    the Riccati, PCG and ADMM backends against a Python loop over the same
    tick module, drawing from a generator and from given draws: bit for
    bit; on PCG (run to convergence) and ADMM against the TPU package's
    ``fused=False`` loop with its key chain's draws injected (f64): winners
    equal, the rest to that scaled 1e-8;
  * ``ops/while_loop.py``'s capture form (every iteration run, masked)
    against its check-every-4 form inside PCG and ADMM solves whose lanes
    stop at different iterations: results and counts bit for bit;
  * the readable controller (formulation "reference", the tick a
    ``SampledController`` outside K1's coverage captures) on its runner,
    with the JAX ticks' normals injected, against the JAX controller
    (float32): winners equal, u within 1e-4;
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
from indy7_mpc_tpu.dynamics import ee_pos as jax_ee_pos
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.mpc import run_mpc as jax_run_mpc
from indy7_mpc_tpu.mpc.sampled import init_loop_carry as jax_init_loop_carry
from indy7_mpc_tpu.mpc.sampled import make_loop_tick as jax_make_loop_tick
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.models.convert import carry_from_numpy, controller_state_from_npz
from indy7_mpc_tpu_torch.mpc import (
    TickDraws, init_loop_carry, make_loop_tick, reference, run_mpc, run_sampled_mpc,
    run_tracking_mpc,
)
from indy7_mpc_tpu_torch.mpc.graphed import TickRunner
from indy7_mpc_tpu_torch.mpc.point_to_goal import make_mpc_tick
from indy7_mpc_tpu_torch.mpc.tracking import make_tracking_tick
from indy7_mpc_tpu_torch.ops import admm, pcg, while_loop
from indy7_mpc_tpu_torch.ops.kkt import QPBlocks
from indy7_mpc_tpu_torch.runtime import InProcessPlant, SampledController

B, N, DT, TICKS, ATOL = 4, 8, 0.01, 3, 1e-8
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]
WRENCH = [5.0, 0.0, 15.0, 0.0, 0.0, 0.0]


def _x0():
    return torch.as_tensor(np.r_[INIT_Q, np.zeros(6)])


def _leaves(tree):
    if tree is None or isinstance(tree, torch.Tensor):
        return [tree]
    return [v for t in tree for v in _leaves(t)]


def _close_scaled(got, want, name):
    """Within ATOL after scaling by max(1, max |want|): the bound of the
    iterative backends' own tests (tests/test_torch_{pcg,admm}.py and
    tests/test_torch_mpc.py's selector test), since PCG and ADMM stop on a
    relative residual."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / max(1.0, np.abs(want).max())
    assert err <= ATOL, f"{name}: scaled error {err:.3e}"


def _assert_equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The single-lane loops.
# ---------------------------------------------------------------------------

def _endpoints():
    ee0 = np.asarray(jax_ee_pos(jax_indy7(dtype=jnp.float64), jnp.asarray(INIT_Q)))
    return np.stack([ee0 + [0.02, 0.0, -0.02], ee0 + [-0.05, 0.05, -0.05]])


def _fig8():
    return reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)[196:]


SINGLE_LANE = {
    "run_mpc": cfg.SQPConfig(max_iters=2),
    "run_mpc_admm": cfg.SQPConfig(max_iters=1, qp_backend="admm"),
    "run_tracking_mpc": cfg.SQPConfig(max_iters=1),
}


def _single_lane(loop):
    """(make_*_tick(...), run_*(n)) for a loop of SINGLE_LANE, f64, a true
    wrench on the plant."""
    model, sqp, w = indy7(torch.float64), SINGLE_LANE[loop], torch.tensor(WRENCH,
                                                                           dtype=torch.float64)
    if loop.startswith("run_mpc"):
        args = (model, cfg.CostConfig(), sqp, cfg.MPCConfig(N=N, dt=DT), _x0(), _endpoints())
        return (make_mpc_tick(*args, wrench_world=w),
                lambda n: run_mpc(*args, n, wrench_world=w))
    args = (model, cfg.CostConfig(), sqp, cfg.MPCConfig(N=N, dt=DT), _x0(), _fig8())
    return (make_tracking_tick(*args, wrench_world=w, solver_wrench=w),
            lambda n: run_tracking_mpc(*args, n, wrench_world=w, solver_wrench=w))


@pytest.mark.parametrize("loop", list(SINGLE_LANE))
def test_single_lane_runner_equals_python_loop(loop):
    """``run_mpc`` / ``run_tracking_mpc`` (the tick on the runner's buffers)
    against the same number of calls of its tick from the same carry: every
    trace row and the final carry, ADMM's warm start included, bit for
    bit."""
    (tick, carry), run = _single_lane(loop)
    steps = 5
    rows = []
    for _ in range(steps):
        carry, row = tick(carry)
        rows.append(row)
    final, trace = run(steps)
    for f in trace._fields:
        assert torch.equal(getattr(trace, f), torch.stack([getattr(r, f) for r in rows])), f
    _assert_equal_trees(final, carry)
    if loop == "run_mpc_admm":
        assert final.state.admm_z is not None and final.state.admm_y is not None


def test_run_mpc_on_admm_matches_jax():
    """``run_mpc`` with ``qp_backend="admm"`` (the readable solver, ADMM's
    iterate carried across ticks in ``SolverState``) against the TPU
    package's ``run_mpc`` (f64): states, controls, goal distances and the
    final carry, ADMM's iterate included, to the scaled 1e-8, the goal
    indices equal."""
    model, endpoints = jax_indy7(dtype=jnp.float64), _endpoints()
    sqp = SINGLE_LANE["run_mpc_admm"]
    jsqp = jcfg.SQPConfig(max_iters=sqp.max_iters, qp_backend="admm")
    final_j, jt = jax.jit(lambda x: jax_run_mpc(
        model, jcfg.CostConfig(), jsqp, jcfg.MPCConfig(N=N, dt=DT), x, endpoints, 4,
        wrench_world=jnp.asarray(WRENCH)))(jnp.asarray(_x0().numpy()))
    final, pt = _single_lane("run_mpc_admm")[1](4)
    np.testing.assert_array_equal(pt.goal_idx.numpy(), np.asarray(jt.goal_idx))
    for f in ("x", "u", "goal_dist"):
        _close_scaled(getattr(pt, f).numpy(), getattr(jt, f), f)
    for f in ("x", "X", "U"):
        _close_scaled(getattr(final, f).numpy(), getattr(final_j, f), f)
    for f in ("admm_z", "admm_y"):
        _close_scaled(getattr(final.state, f).numpy(), getattr(final_j.state, f), f)


# ---------------------------------------------------------------------------
# The readable loop.
# ---------------------------------------------------------------------------

READABLE = ("riccati", "pcg", "admm")


def _ref():
    # 198 rows in: the 200-row padding ends inside the first window.
    return reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)[198:]


# PCG in the comparison with JAX runs to convergence (a 1e-11 residual):
# stopped short, at its default 1e-7 (or 1e-9, 1e-10 with a cap of 200),
# the two sides' iterates differ by CG's rounding, which the plant carries
# to 4.8e-8 (3.3e-6, 3.5e-6) in the scaled final x by tick 3; converged,
# the loop agrees to 6.8e-10 there.
JAX_PCG = dict(pcg_tol=1e-11, pcg_max_iters=400)


def _readable_configs(backend, **sqp):
    return (cfg.CostConfig(), cfg.SQPConfig(max_iters=1, qp_backend=backend, **sqp),
            cfg.MPCConfig(N=N, dt=DT), cfg.SampleConfig(batch_size=B))


@pytest.mark.parametrize("source", ["generator", "draws"])
@pytest.mark.parametrize("backend", READABLE)
def test_readable_loop_runner_equals_python_loop(backend, source):
    """``run_sampled_mpc(fused=False)`` against TICKS calls of the readable
    tick module (``make_loop_tick(fused=False)``) from the same carry:
    trace, carry and generator bit for bit."""
    model, cfgs, ref = indy7(torch.float64), _readable_configs(backend), _ref()
    rng = np.random.default_rng(6)
    draws = None
    if source == "draws":
        draws = [TickDraws(torch.as_tensor(rng.normal(size=(B, 6))),
                           torch.as_tensor(rng.normal(size=3)),
                           torch.as_tensor(rng.normal(size=(cfg.PERTURBED_PLANT.substeps, 6))))
                 for _ in range(TICKS)]
    gens = [torch.Generator().manual_seed(2) for _ in range(2)]
    tick = make_loop_tick(model, *cfgs, torch.as_tensor(ref), plant_cfg=cfg.PERTURBED_PLANT,
                          generator=gens[0], fused=False)
    carries = [init_loop_carry(model, cfgs[2], cfgs[3], _x0(), F_TRUE0, g) for g in gens]
    rows, carry = [], carries[0]
    for t in range(TICKS):
        carry, row = tick(carry, None if draws is None else draws[t])
        rows.append(row)
    final, trace = run_sampled_mpc(model, *cfgs, _x0(), ref, TICKS, F_TRUE0, gens[1],
                                   plant_cfg=cfg.PERTURBED_PLANT, carry0=carries[1],
                                   draws=draws, fused=False)
    for f in trace._fields:
        assert torch.equal(getattr(trace, f), torch.stack([getattr(r, f) for r in rows])), f
    _assert_equal_trees(final, carry)
    assert torch.equal(gens[1].get_state(), gens[0].get_state())


def _replay_draws(key):
    """One tick's draws, exactly as the JAX readable tick consumes its key
    on the perturbed plant (tests/test_torch_slice.py's replay)."""
    _, k_tick, k_walk, k_plant = jax.random.split(key, 4)
    key_r, _ = jax.random.split(k_tick)
    plant, k = [], k_plant
    for _ in range(cfg.PERTURBED_PLANT.substeps):
        k, ks = jax.random.split(k)
        plant.append(np.asarray(jax.random.normal(ks, (6,), jnp.float64)))
    return TickDraws(
        resample=torch.tensor(np.asarray(jax.random.normal(key_r, (B, 6), jnp.float64))),
        walk=torch.tensor(np.asarray(jax.random.normal(k_walk, (3,), jnp.float64))),
        plant=torch.as_tensor(np.stack(plant)),
    )


@pytest.mark.parametrize("backend", ["pcg", "admm"])
def test_readable_loop_runner_matches_jax(backend):
    """The readable loop on the runner against the TPU package's
    ``fused=False`` loop (its readable tick jitted once, f64) on the PCG and
    ADMM backends (PCG run to convergence, see JAX_PCG), the JAX draws
    replayed from its key chain: winners equal, the rest to the scaled
    1e-8."""
    model, sqp = jax_indy7(dtype=jnp.float64), JAX_PCG if backend == "pcg" else {}
    jcfgs = (jcfg.CostConfig(), jcfg.SQPConfig(max_iters=1, qp_backend=backend, **sqp),
             jcfg.MPCConfig(N=N, dt=DT), jcfg.SampleConfig(batch_size=B))
    tick = jax.jit(lambda c: jax_make_loop_tick(
        model, *jcfgs, jnp.asarray(_ref()), plant_cfg=jcfg.PERTURBED_PLANT, fused=False)(c, None))
    carry = jax_init_loop_carry(model, jcfgs[2], jcfgs[3], jnp.asarray(_x0().numpy()),
                                jnp.asarray(F_TRUE0), jax.random.PRNGKey(42))
    carry0 = carry_from_numpy({f: np.asarray(getattr(carry, f)) for f in carry._fields})
    draws, rows = [], []
    for _ in range(TICKS):
        draws.append(_replay_draws(carry.key))
        carry, row = tick(carry)
        rows.append(row)
    jt = {f: np.stack([np.asarray(getattr(r, f)) for r in rows]) for f in rows[0]._fields}

    final, pt = run_sampled_mpc(indy7(torch.float64), *_readable_configs(backend, **sqp), _x0(),
                                _ref(), TICKS, F_TRUE0, None, plant_cfg=cfg.PERTURBED_PLANT,
                                carry0=carry0, draws=draws, fused=False)
    np.testing.assert_array_equal(pt.best_idx.numpy(), jt["best_idx"])
    for f in ("x", "u", "tracking_error", "f_est", "f_true", "ee_pos", "ee_ref"):
        _close_scaled(getattr(pt, f).numpy(), jt[f], f)
    for f in ("x", "f_batch", "f_true", "X_best", "U_best"):
        _close_scaled(getattr(final, f).numpy(), getattr(carry, f), f)


# ---------------------------------------------------------------------------
# The inner loops' capture form.
# ---------------------------------------------------------------------------

def _qp(lanes, seed):
    """Random well-posed QP blocks at N=8 (measure.qp_blocks' recipe), f64,
    the offsets c and gradients q scaled by 1 to 1e4 over the lanes and
    the Levenberg rho 1e-6 to 1, so that the lanes stop apart."""
    rng = np.random.default_rng(seed)
    nx, nu = 12, 6
    Qh = rng.normal(size=(lanes, N, nx, nx)) * 0.1
    Rh = rng.normal(size=(lanes, N - 1, nu, nu)) * 0.1
    scale = np.logspace(0, 4, lanes)[:, None, None]
    blocks = QPBlocks(*(torch.as_tensor(a) for a in (
        rng.normal(size=(lanes, N - 1, nx, nx)) * 0.1 + np.eye(nx),
        rng.normal(size=(lanes, N - 1, nx, nu)) * 0.1,
        rng.normal(size=(lanes, N - 1, nx)) * 0.01 * scale,
        Qh @ Qh.swapaxes(-1, -2) + 0.1 * np.eye(nx),
        rng.normal(size=(lanes, N, nx)) * 0.1 * scale,
        Rh @ Rh.swapaxes(-1, -2) + 0.5 * np.eye(nu),
        rng.normal(size=(lanes, N - 1, nu)) * 0.1)))
    rho = torch.logspace(-6, 0, lanes, dtype=torch.float64)
    return blocks, torch.as_tensor(rng.normal(size=(lanes, nx)) * 0.1), rho


@pytest.mark.parametrize("solver", ["pcg", "admm"])
def test_while_loop_capture_form_equals_check_form(solver, monkeypatch):
    """The same PCG / ADMM solves with the loop's exit checked every 4
    iterations (eager) and with every iteration run, masked (the form a
    CUDA graph captures): every output and every lane's iteration count
    bit for bit, the lanes stopping at different iterations before the
    cap."""
    blocks, xs, rho = _qp(6, seed=3)
    if solver == "pcg":
        solve = lambda: pcg.solve(blocks, xs, rho, primal_reg=1e-4, tol=1e-6, max_iters=200)
    else:
        solve = lambda: admm.solve(blocks, xs, rho, max_iters=200)
    eager = solve()
    its = eager.iterations
    assert its.max() < 200 and len(set(its.tolist())) > 1
    monkeypatch.setattr(while_loop, "_capturing", lambda t: True)
    _assert_equal_trees(solve(), eager)


# ---------------------------------------------------------------------------
# The readable controller.
# ---------------------------------------------------------------------------

CTL_B = 4
CTL = dict(mpc=dict(N=6, dt=DT), sqp=dict(max_iters=1),
           sample=dict(batch_size=CTL_B, f_ext_std=5.0, f_ext_resample_std=0.5))
F_EXT = [3.0, 0.0, -5.0]


def _hold_ref(ticks):
    ee = np.asarray(jax_ee_pos(jax_indy7(dtype=jnp.float64), jnp.zeros(6)))
    return np.tile(ee, (ticks, 1)).astype(np.float32)


def _readable_controller(ref):
    return SampledController(
        indy7(torch.float32), cfg.CostConfig(formulation="reference"),
        cfg.SQPConfig(**CTL["sqp"]), cfg.MPCConfig(**CTL["mpc"]),
        cfg.SampleConfig(**CTL["sample"]), ref, f_ext_actual=F_EXT, device="cpu",
    )


@pytest.fixture(scope="module")
def jax_readable_controller_run(tmp_path_factory):
    """The JAX controller outside its kernel's coverage (formulation
    "reference": its readable solver) on its nominal in-process plant for 5
    ticks, its state saved before the first; each tick's resampling normals
    replayed from its key."""
    ckpt = str(tmp_path_factory.mktemp("jax_readable_ctl") / "ctl.npz")
    model = jax_indy7(dtype=jnp.float32)
    ref = _hold_ref(400)
    ctl = jrt.SampledController(
        model, jcfg.CostConfig(formulation="reference"), jcfg.SQPConfig(**CTL["sqp"]),
        jcfg.MPCConfig(**CTL["mpc"]), jcfg.SampleConfig(**CTL["sample"]), ref,
        f_ext_actual=F_EXT,
    )
    ctl.save_checkpoint(ckpt)
    plant = jrt.InProcessPlant(model, np.zeros(12), DT)
    plant.send_wrench(ctl.f_ext_actual)
    normals, us, best = [], [], []
    for _ in range(5):
        key_r, _ = jax.random.split(jax.random.split(ctl.key)[1])
        normals.append(np.array(jax.random.normal(key_r, (CTL_B, 6), jnp.float32)))
        u, info = ctl.on_state(plant.recv_state().x, DT)
        plant.send_command(u)
        us.append(np.array(u))
        best.append(info["best_idx"])
    return ckpt, ref, normals, (np.asarray(us), np.asarray(best))


def test_readable_controller_runner_matches_jax_controller(jax_readable_controller_run):
    """The readable controller's runner stepped with the JAX ticks' normals,
    from the JAX controller's state, against its 5 ticks: winners equal, u
    within 1e-4."""
    ckpt, ref, normals, (ju, jbest) = jax_readable_controller_run
    ctl = _readable_controller(ref)
    ctl.load_state(controller_state_from_npz(ckpt))
    plant = InProcessPlant(indy7(torch.float32), np.zeros(12), DT, device="cpu")
    plant.send_wrench(ctl.f_ext_actual)
    us, best = [], []
    for n in normals:
        ctl.ref_offset += 1.0  # on_state's elapsed / dt
        host = ctl.runner.step(plant.recv_state().x, int(ctl.ref_offset),
                               normals=torch.as_tensor(n))
        plant.send_command(host[:6])
        us.append(host[:6])
        best.append(int(host[6]))
    np.testing.assert_array_equal(best, jbest)
    np.testing.assert_allclose(np.asarray(us), ju, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# Fixed addresses.
# ---------------------------------------------------------------------------

def _addresses(tensors):
    return [t.data_ptr() for t in tensors]


@pytest.mark.parametrize("loop", ["run_mpc_admm", "run_tracking_mpc", "readable_pcg"])
def test_loop_runner_buffers_keep_their_addresses(loop):
    """A runner's buffers keep their addresses over runs and a ``load``; a
    carry of another shape or structure is refused."""
    if loop.startswith("readable"):
        model, cfgs = indy7(torch.float64), _readable_configs("pcg")
        gen = torch.Generator().manual_seed(1)
        tick = make_loop_tick(model, *cfgs, torch.as_tensor(_ref()), plant_cfg=cfg.PERTURBED_PLANT,
                              generator=gen, fused=False)
        carry = init_loop_carry(model, cfgs[2], cfgs[3], _x0(), F_TRUE0, gen)
    else:
        (tick, carry), _ = _single_lane(loop)
    runner = TickRunner(tick, carry, rows=TICKS)
    runner.run(1)
    before = _addresses(runner.buffers())
    assert len(before) == len([v for v in _leaves(carry) if v is not None]) + 1 + len(
        runner.trace_bufs)
    runner.run(TICKS)
    runner.load(carry)
    assert _addresses(runner.buffers()) == before
    bad = carry._replace(X=torch.zeros(N + 1, 12, dtype=torch.float64)) if hasattr(carry, "X") \
        else carry._replace(f_batch=torch.zeros(B + 1, 6, dtype=torch.float64))
    with pytest.raises(ValueError):
        runner.load(bad)
    if loop == "run_mpc_admm":  # the ADMM iterate's slot is part of the structure
        with pytest.raises(ValueError):
            runner.load(carry._replace(state=carry.state._replace(admm_z=None)))


def test_readable_controller_buffers_keep_their_addresses(tmp_path):
    ref = _hold_ref(400)
    ctl = _readable_controller(ref)
    plant = InProcessPlant(indy7(torch.float32), np.zeros(12), DT, device="cpu")
    before = _addresses(ctl.runner.buffers())
    for _ in range(3):
        u, _ = ctl.on_state(plant.recv_state().x, DT)
        plant.send_command(u)
    assert _addresses(ctl.runner.buffers()) == before
    ckpt = ctl.save_checkpoint(str(tmp_path / "ctl.npz"))
    ctl.reset_warm_start()
    assert ctl.x_last is None and not ctl.X_best.any() and not ctl.u_last.any()
    assert _addresses(ctl.runner.buffers()) == before
    other = _readable_controller(ref)
    other.load_checkpoint(ckpt)
    ctl.load_checkpoint(ckpt)
    assert _addresses(ctl.runner.buffers()) == before
    for name in ("X_best", "U_best", "f_batch", "x_last", "u_last"):
        assert torch.equal(getattr(ctl, name), getattr(other, name)), name
